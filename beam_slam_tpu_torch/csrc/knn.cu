// Exact k-nearest-neighbour top-k for Hopper (sm_90a) — kernel K2 of the
// PyTorch port.
//
// Replaces the TPU kernel beam_slam_tpu/ops/pallas_knn.py::knn_topk (body
// _knn_kernel): for every query point, the k nearest valid reference points
// and their squared distances, without ever writing the [Q, R] distance
// matrix. It computes the function of the reference's own path (exact top-k
// over ||q||^2 + ||r||^2 - 2 q.r with invalid refs at +inf), not the TPU
// kernel's packed-key approximation: the index travels beside the distance,
// so there is no truncation of distances and no cap on R.
//
// What bounds it on this card: operations. Each (query, ref) pair costs ~9
// fp32 operations (3 products, 2 sums for q.r, 3 for the expansion, one
// compare); the bytes (Q + R points, Q*k results) are a few hundred KB.
// At the LIO shapes (Q=7584, R=20480) that is ~1.4 GFLOP against 67 TFLOP/s.
//
// Design (right and simple first):
//   * one thread per query, blocks of 128 queries;
//   * refs stream through shared memory in tiles of 1024 points, stored as
//     float4 (x, y, z, ||r||^2) with ||r||^2 = +inf for invalid and padded
//     refs, so an invalid ref never beats an empty slot;
//   * each thread keeps its sorted top-k in registers (templated on k, fully
//     unrolled insertion). Refs are visited in ascending index and the
//     insertion orders by (distance, index), so ties keep the lower index,
//     as the reference's top_k does;
//   * slots still empty at the end (+inf) get index 0, which is in range:
//     callers gather map[idx] before masking with isfinite(d2).
// Known limit, left for a later PR: at Q=7584 the grid is 60 blocks for 132
// SMs, four warps each, so the card is far from its operation bound.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kBlock)
knn_topk_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                const bool* __restrict__ ref_valid, int64_t* __restrict__ out_idx,
                float* __restrict__ out_d2, int Q, int R) {
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

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = 0x7fffffff;
  }

  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < kTile; t += kBlock) {
      float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (t < n && ref_valid[base + t]) {
        const float rx = ref[3 * (base + t) + 0];
        const float ry = ref[3 * (base + t) + 1];
        const float rz = ref[3 * (base + t) + 2];
        v = make_float4(rx, ry, rz, rx * rx + ry * ry + rz * rz);
      }
      tile[t] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float4 r = tile[t];
      const float d = qq + r.w - 2.0f * (qx * r.x + qy * r.y + qz * r.z);
      if (d < bd[K - 1]) {  // strict: an equal distance has a higher index
        float cd = d;
        int ci = base + t;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const bool lt = cd < bd[j] || (cd == bd[j] && ci < bi[j]);
          if (lt) {
            const float td = bd[j];
            bd[j] = cd;
            cd = td;
            const int ti = bi[j];
            bi[j] = ci;
            ci = ti;
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool empty = !(bd[j] < CUDART_INF_F);
      out_idx[(int64_t)qi * K + j] = empty ? 0 : bi[j];
      out_d2[(int64_t)qi * K + j] = bd[j];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, const float* r, const bool* v, int64_t* idx,
                   float* d2, int Q, int R, cudaStream_t s) {
  const int blocks = (Q + kBlock - 1) / kBlock;
  knn_topk_kernel<K><<<blocks, kBlock, 0, s>>>(q, r, v, idx, d2, Q, R);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). query [Q,3] f32, ref [R,3] f32,
// ref_valid [R] bool, all contiguous on the device; writes idx [Q,k] int64
// and d2 [Q,k] f32. k must be one of 1, 5, 8, 10 (the repo's callers); any
// other k returns cudaErrorInvalidValue without launching.
extern "C" int bst_knn_topk_f32(const void* query, const void* ref,
                                const void* ref_valid, void* out_idx,
                                void* out_d2, int Q, int R, int k,
                                void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  const bool* v = static_cast<const bool*>(ref_valid);
  int64_t* idx = static_cast<int64_t*>(out_idx);
  float* d2 = static_cast<float*>(out_d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(q, r, v, idx, d2, Q, R, s);
    case 5: return launch<5>(q, r, v, idx, d2, Q, R, s);
    case 8: return launch<8>(q, r, v, idx, d2, Q, R, s);
    case 10: return launch<10>(q, r, v, idx, d2, Q, R, s);
    default: return cudaErrorInvalidValue;
  }
}
