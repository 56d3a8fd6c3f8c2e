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
// shared with the plain version (ops/moments.py). The distance uses the
// reference's expansion ||q||^2 + ||r||^2 - 2 q.r.
//
// Invalid refs stand, in the reference (lidar/registration.py:
// _radius_moments), at a sentinel coordinate 1e5 far, so they fail the
// radius test unless the radius reaches it. Here they are never scanned:
// the kernel counts them, and adds that many sentinel points to a query
// whose radius holds the sentinel.
//
// What bounds it on this card: operations, and only those of valid refs.
// Each (query, valid ref) pair costs ~9 fp32 operations for the distance and
// the radius test, and each neighbour found ~10 more for the moments; the
// bytes (Q + R points, Q*13 moments) are a few hundred KB. On the LIO path
// ~3.5K of the map's 20480 refs are valid, and they come first.
//
// Design: K2's grid (ref_steps.cuh). A thread-block cluster of S CTAs of 8
// warps takes 32 queries, one a lane; R is dealt to its S*8 warps in steps
// of 64 refs, round-robin, each step compacted to its valid refs in shared
// memory, four steps staged at once. Each warp sums the 10 distinct
// moments of its refs for the lane's query in registers, in fp32; then
// warp 0 adds the other warps' sums, in warp order, from shared memory, and
// rank 0's warp 0 adds the other ranks' over distributed shared memory,
// between two cluster barriers, in rank order. The order of the sums
// depends on the split but not on timing, so a launch is deterministic to
// the bit; a matmul sums in another order (ops/moments.py states the
// tolerance). The symmetric outer-product columns are written twice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ref_steps.cuh"

namespace cg = cooperative_groups;
using namespace bst;

namespace {

constexpr float kSentinel = 1.0e5f;
constexpr int NM = 11;  // n, 3 first and 6 second moments, invalid refs

union Smem {
  Staged scan[W];       // each warp's staged steps
  float sums[W][NM][QT];  // warps 1..W-1 of this CTA; slot 0 its total
};

__global__ void __launch_bounds__(NT)
radius_moments_kernel(const float* __restrict__ query,
                      const float* __restrict__ ref,
                      const bool* __restrict__ ref_valid,
                      float* __restrict__ out, int Q, int R, float rad2) {
  __shared__ Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = (blockIdx.x / S) * QT + lane;
  const bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi + 0];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  const float qq = qx * qx + qy * qy + qz * qz;
  const float lim = active ? rad2 : -CUDART_INF_F;  // none past Q

  // n, sx, sy, sz, xx, xy, xz, yy, yz, zz, invalid refs skipped
  float m[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j) m[j] = 0.f;

  Staged& st = sm.scan[warp];
  const int P = S * W;
  const int steps = (R + T - 1) / T;
  for (int g0 = rank * W + warp; g0 < steps; g0 += B * P) {
    m[10] += (float)stage_steps(ref, ref_valid, R, g0, P, lane, st);
    for (int b = 0; b < B; ++b) {
      const int n = st.n[b];
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float4 r = st.ref[b][t];
        const float d = qq + r.w - 2.0f * (qx * r.x + qy * r.y + qz * r.z);
        if (d < lim) {
          m[0] += 1.f;
          m[1] += r.x;
          m[2] += r.y;
          m[3] += r.z;
          m[4] += r.x * r.x;
          m[5] += r.x * r.y;
          m[6] += r.x * r.z;
          m[7] += r.y * r.y;
          m[8] += r.y * r.z;
          m[9] += r.z * r.z;
        }
      }
    }
  }
  __syncthreads();  // the staging buffers become the merge buffers

  // the CTA's W sums into warp 0's, in warp order
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < NM; ++j) sm.sums[warp][j][lane] = m[j];
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < W; ++w) {
#pragma unroll
      for (int j = 0; j < NM; ++j) m[j] += sm.sums[w][j][lane];
    }
  }
  // the cluster's S sums into rank 0's, in rank order
  if (S > 1) {
    if (warp == 0 && rank > 0) {
#pragma unroll
      for (int j = 0; j < NM; ++j) sm.sums[0][j][lane] = m[j];
    }
    cluster.sync();
    if (warp == 0 && rank == 0) {
      for (int r = 1; r < S; ++r) {
        const float* s = cluster.map_shared_rank(&sm.sums[0][0][0], r);
#pragma unroll
        for (int j = 0; j < NM; ++j) m[j] += s[j * QT + lane];
      }
    }
    cluster.sync();  // rank 0 has read every rank's sums
  }

  if (warp == 0 && rank == 0 && active) {
    // the skipped invalid refs, at the sentinel as the reference has them
    const float ss = 3.0f * kSentinel * kSentinel;
    const float ds = qq + ss - 2.0f * (qx + qy + qz) * kSentinel;
    if (ds < rad2) {
      const float c = m[10];
      m[0] += c;
#pragma unroll
      for (int j = 1; j < 4; ++j) m[j] += c * kSentinel;
#pragma unroll
      for (int j = 4; j < 10; ++j) m[j] += c * (kSentinel * kSentinel);
    }
    float* o = out + (int64_t)qi * 13;
    o[0] = m[0];
    o[1] = m[1];
    o[2] = m[2];
    o[3] = m[3];
    o[4] = m[4];
    o[5] = m[5];
    o[6] = m[6];
    o[7] = m[5];
    o[8] = m[7];
    o[9] = m[8];
    o[10] = m[6];
    o[11] = m[8];
    o[12] = m[9];
  }
}

}  // namespace

// How many clusters of S CTAs of the kernel the current device can hold at
// once; 0 where it cannot schedule that size.
extern "C" int bst_moments_max_active_clusters(int S) {
  return max_active_clusters(radius_moments_kernel, S);
}

// Plain C interface (loaded with ctypes). query [Q,3] f32, ref [R,3] f32,
// ref_valid [R] bool, contiguous on the device; writes out [Q,13] f32. One
// cluster of `cluster` CTAs (1, 2, 4 or 8) per 32 queries; R may be 0. Q < 1
// or another cluster size returns cudaErrorInvalidValue without launching.
extern "C" int bst_radius_moments_f32(const void* query, const void* ref,
                                      const void* ref_valid, void* out, int Q,
                                      int R, float rad2, int cluster,
                                      void* stream) {
  if (Q < 1 || R < 0 || !valid_cluster(cluster))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config((Q + QT - 1) / QT, cluster,
                    static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, radius_moments_kernel, static_cast<const float*>(query),
      static_cast<const float*>(ref), static_cast<const bool*>(ref_valid),
      static_cast<float*>(out), Q, R, rad2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
