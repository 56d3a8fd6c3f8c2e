// Fixed-radius neighbourhood moments for Hopper (sm_90a) — kernel K3 of the
// PyTorch port.
//
// Replaces the TPU kernel beam_slam_tpu/ops/pallas_moments.py::radius_moments
// (body _moments_kernel): for every query point, the zeroth, first and second
// moments of the valid reference points within a fixed radius,
//     n = sum [d2 < rad^2],  m1 = sum w r,  m2 = sum w r r^T,
// written as a [Q, 13] accumulator [1, x, y, z, xx, xy, xz, yx, yy, yz, zx,
// zy, zz]. The [Q, R] distance and mask blocks never reach device memory.
// The finishing step (centroid, centred scatter) stays in plain PyTorch,
// shared with the plain version (ops/moments.py).
//
// Invalid refs are pushed to the reference's 1e5 sentinel coordinate
// (lidar/registration.py:_radius_moments), so they fail the radius test the
// same way they do there; the distance uses the reference's expansion
// ||q||^2 + ||r||^2 - 2 q.r.
//
// What bounds it on this card: operations. Each (query, ref) pair costs ~9
// fp32 operations for the distance and the radius test, and each neighbour
// found ~10 more for the moments; the bytes (Q + R points, Q*13 moments) are
// a few hundred KB.
//
// Design (right and simple first): one thread per query, blocks of 128
// queries; refs stream through shared memory in tiles of 1024 float4
// (x, y, z, ||r||^2); the 10 distinct moments accumulate in registers in
// fp32, in ref order (a matmul sums in another order: ops/moments.py states
// the tolerance); the symmetric outer-product columns are written twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 1024;
constexpr float kSentinel = 1.0e5f;

__global__ void __launch_bounds__(kBlock)
radius_moments_kernel(const float* __restrict__ query,
                      const float* __restrict__ ref,
                      const bool* __restrict__ ref_valid,
                      float* __restrict__ out, int Q, int R, float rad2) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi + 0];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  const float qq = qx * qx + qy * qy + qz * qz;

  float n = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float xx = 0.f, xy = 0.f, xz = 0.f, yy = 0.f, yz = 0.f, zz = 0.f;

  for (int base = 0; base < R; base += kTile) {
    const int cnt = min(kTile, R - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += kBlock) {
      float rx = kSentinel, ry = kSentinel, rz = kSentinel;
      if (ref_valid[base + t]) {
        rx = ref[3 * (base + t) + 0];
        ry = ref[3 * (base + t) + 1];
        rz = ref[3 * (base + t) + 2];
      }
      tile[t] = make_float4(rx, ry, rz, rx * rx + ry * ry + rz * rz);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < cnt; ++t) {
      const float4 r = tile[t];
      const float d = qq + r.w - 2.0f * (qx * r.x + qy * r.y + qz * r.z);
      if (d < rad2) {
        n += 1.f;
        sx += r.x;
        sy += r.y;
        sz += r.z;
        xx += r.x * r.x;
        xy += r.x * r.y;
        xz += r.x * r.z;
        yy += r.y * r.y;
        yz += r.y * r.z;
        zz += r.z * r.z;
      }
    }
  }

  if (active) {
    float* o = out + (int64_t)qi * 13;
    o[0] = n;
    o[1] = sx;
    o[2] = sy;
    o[3] = sz;
    o[4] = xx;
    o[5] = xy;
    o[6] = xz;
    o[7] = xy;
    o[8] = yy;
    o[9] = yz;
    o[10] = xz;
    o[11] = yz;
    o[12] = zz;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). query [Q,3] f32, ref [R,3] f32,
// ref_valid [R] bool, contiguous on the device; writes out [Q,13] f32.
extern "C" int bst_radius_moments_f32(const void* query, const void* ref,
                                      const void* ref_valid, void* out, int Q,
                                      int R, float rad2, void* stream) {
  const int blocks = (Q + kBlock - 1) / kBlock;
  radius_moments_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref),
      static_cast<const bool*>(ref_valid), static_cast<float*>(out), Q, R,
      rad2);
  return cudaGetLastError();
}
