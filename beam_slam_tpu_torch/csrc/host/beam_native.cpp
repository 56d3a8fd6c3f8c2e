// Host-side C++ for the PyTorch port's per-scan ingest path, built with g++
// into a plain-C-ABI shared library that beam_slam_tpu_torch/ops/native.py
// loads with ctypes (no pybind11, no PyTorch headers):
//
//   * organize_scan: bin an unordered (x,y,z,ring,time) cloud into the
//     ring-major azimuth-sorted grid consumed by the LOAM feature
//     extraction (replaces PCL ring indexing; the numpy version in
//     beam_slam_tpu_torch/lidar/cloud.py is its plain counterpart).
//   * voxel_downsample: centroid voxel filter for map maintenance (the
//     reference's beam_filtering voxel downsample).
//   * interp_positions, index_log, decode_imu_batch: trajectory
//     interpolation and the binary sensor-log reader (the rosbag-equivalent
//     data loader of beam_slam_tpu_torch/pipeline/sensor_log.py).
//
// The record format and every function's results are those of the JAX
// package's native library, so either package reads the other's logs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Bin points into a ring-major, azimuth-sorted grid.
// pts: [n,3] xyz; rings: [n]; times: [n] (may be null);
// out_xyz: [n_rings*width*3]; out_time: [n_rings*width];
// out_valid: [n_rings*width] (0/1). Returns number of points placed.
int organize_scan(const float* pts, const int32_t* rings, const float* times,
                  int n, int n_rings, int width, float* out_xyz,
                  float* out_time, uint8_t* out_valid) {
  std::memset(out_xyz, 0, sizeof(float) * (size_t)n_rings * width * 3);
  std::memset(out_time, 0, sizeof(float) * (size_t)n_rings * width);
  std::memset(out_valid, 0, (size_t)n_rings * width);

  // index + azimuth per ring, then sort each ring by azimuth
  std::vector<std::vector<std::pair<float, int>>> per_ring(n_rings);
  for (int i = 0; i < n; ++i) {
    int r = rings[i];
    if (r < 0 || r >= n_rings) continue;
    float az = std::atan2(pts[i * 3 + 1], pts[i * 3 + 0]);
    per_ring[r].emplace_back(az, i);
  }
  int placed = 0;
  for (int r = 0; r < n_rings; ++r) {
    auto& v = per_ring[r];
    std::sort(v.begin(), v.end());
    int m = std::min((int)v.size(), width);
    for (int k = 0; k < m; ++k) {
      int i = v[k].second;
      size_t o = ((size_t)r * width + k);
      out_xyz[o * 3 + 0] = pts[i * 3 + 0];
      out_xyz[o * 3 + 1] = pts[i * 3 + 1];
      out_xyz[o * 3 + 2] = pts[i * 3 + 2];
      out_time[o] = times ? times[i] : 0.0f;
      out_valid[o] = 1;
      ++placed;
    }
  }
  return placed;
}

// Centroid voxel downsample. pts: [n,3]; valid: [n] (may be null).
// Writes up to cap centroids into out [cap,3]; returns the count.
int voxel_downsample(const float* pts, const uint8_t* valid, int n,
                     float voxel, float* out, int cap) {
  if (voxel <= 0.0f || n <= 0) return 0;
  struct Acc {
    double x = 0, y = 0, z = 0;
    int cnt = 0;
  };
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve((size_t)n / 4 + 1);
  const float inv = 1.0f / voxel;
  for (int i = 0; i < n; ++i) {
    if (valid && !valid[i]) continue;
    // offset keeps coordinates positive for up to ±1 km
    int64_t cx = (int64_t)std::floor(pts[i * 3 + 0] * inv) + (1 << 20);
    int64_t cy = (int64_t)std::floor(pts[i * 3 + 1] * inv) + (1 << 20);
    int64_t cz = (int64_t)std::floor(pts[i * 3 + 2] * inv) + (1 << 20);
    uint64_t key = ((uint64_t)(cx & 0x1FFFFF) << 42) |
                   ((uint64_t)(cy & 0x1FFFFF) << 21) |
                   (uint64_t)(cz & 0x1FFFFF);
    Acc& a = cells[key];
    a.x += pts[i * 3 + 0];
    a.y += pts[i * 3 + 1];
    a.z += pts[i * 3 + 2];
    a.cnt += 1;
  }
  int m = 0;
  for (auto& kv : cells) {
    if (m >= cap) break;
    out[m * 3 + 0] = (float)(kv.second.x / kv.second.cnt);
    out[m * 3 + 1] = (float)(kv.second.y / kv.second.cnt);
    out[m * 3 + 2] = (float)(kv.second.z / kv.second.cnt);
    ++m;
  }
  return m;
}

// Linear-interpolate a piecewise trajectory at query times.
// traj_t: [n] sorted; traj_p: [n,3]; q_t: [m]; out: [m,3].
void interp_positions(const double* traj_t, const float* traj_p, int n,
                      const double* q_t, int m, float* out) {
  for (int j = 0; j < m; ++j) {
    double t = q_t[j];
    const double* it = std::lower_bound(traj_t, traj_t + n, t);
    int i = (int)(it - traj_t);
    if (i <= 0) {
      std::memcpy(out + j * 3, traj_p, 3 * sizeof(float));
    } else if (i >= n) {
      std::memcpy(out + j * 3, traj_p + (n - 1) * 3, 3 * sizeof(float));
    } else {
      double s = (t - traj_t[i - 1]) /
                 std::max(traj_t[i] - traj_t[i - 1], 1e-12);
      for (int k = 0; k < 3; ++k) {
        out[j * 3 + k] = (float)((1.0 - s) * traj_p[(i - 1) * 3 + k] +
                                 s * traj_p[i * 3 + k]);
      }
    }
  }
}

// --- binary sensor-log data loader (pipeline/sensor_log.py format) -------
//
// Record framing after the 6-byte header (magic "BSLG" + u16 version):
//   u8 type | f64 stamp | u32 payload_len | payload  (little endian, packed)
//
// index_log scans the whole buffer once and returns per-record
// (type, stamp, payload_offset, payload_len) — the rosbag-index analog that
// makes replay seeks and type filters O(records) with no Python-loop
// per-record overhead.
int64_t index_log(const uint8_t* buf, int64_t n, uint8_t* out_types,
                  double* out_stamps, int64_t* out_offsets,
                  int64_t* out_sizes, int64_t max_records) {
  int64_t pos = 6;  // header
  int64_t count = 0;
  while (pos + 13 <= n && count < max_records) {
    uint8_t type = buf[pos];
    double stamp;
    uint32_t len;
    std::memcpy(&stamp, buf + pos + 1, 8);
    std::memcpy(&len, buf + pos + 9, 4);
    int64_t payload = pos + 13;
    if (payload + (int64_t)len > n) break;  // truncated tail
    out_types[count] = type;
    out_stamps[count] = stamp;
    out_offsets[count] = payload;
    out_sizes[count] = (int64_t)len;
    ++count;
    pos = payload + len;
  }
  return count;
}

// Gather IMU payloads ([wx wy wz ax ay az] f32) at the given offsets into
// contiguous arrays — bulk ingestion for 200 Hz streams.
void decode_imu_batch(const uint8_t* buf, const int64_t* offsets, int n,
                      float* out_wa) {
  for (int i = 0; i < n; ++i) {
    std::memcpy(out_wa + (size_t)i * 6, buf + offsets[i],
                sizeof(float) * 6);
  }
}

}  // extern "C"
