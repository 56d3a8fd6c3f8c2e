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
// What bounds it on this card: operations, and only those of valid refs.
// Each (query, valid ref) pair costs ~9 fp32 operations (3 products, 2 sums
// for q.r, 3 for the expansion, one compare); the bytes (Q + R points, Q*k
// results) are a few hundred KB. On the LIO path the world map is deduped
// into a fixed capacity with its valid points first: at (7584, 20480) only
// ~3.5K refs are valid. What holds it above that bound is the insertions:
// a lane inserts where a ref beats its k-th, and the whole warp runs the
// insertion when any lane does. Each of the S*W parts of R warms up k-lists
// of its own, and with a few hundred valid refs a part the lists are still
// warming up when the part ends.
//
// Design (grid and staging in ref_steps.cuh, shared with K3):
//   * a thread-block cluster of S CTAs (S in {1, 2, 4, 8}, chosen by the
//     wrapper from what the card holds at once) takes a tile of 32 queries,
//     one a lane; its CTAs have 8 warps each. R is dealt to the cluster's
//     S*8 warps in steps of 64 refs, round-robin; a warp stages four of its
//     steps at once, compacted to their valid refs, in shared memory;
//   * every warp keeps the lane's sorted k-list of (d^2, index) in
//     registers (templated on k). The scan reads each packed ref as one
//     broadcast float4 and inserts where d < the list's k-th. A warp visits
//     its refs in ascending index, so an equal distance already in the list
//     has a lower index and the strict test keeps ties in index order;
//   * merge, inside the launch, ordered by (d^2, index) so that the result
//     does not depend on the split: warps 1..7 leave their lists in shared
//     memory and warp 0 takes them in, each list until its first entry that
//     loses; then, across the cluster, rank 0's warp 0 takes in the other
//     ranks' merged lists over distributed shared memory, between two
//     cluster barriers (the second keeps every rank's shared memory alive
//     until rank 0 has read it). Every thread of every rank reaches both
//     barriers, whatever its share of R or its queries;
//   * slots still empty at the end (+inf) get index 0, which is in range:
//     callers gather map[idx] before masking with isfinite(d2).
// A threshold shared by a CTA's warps (enter only where d <= the least k-th
// any of them has published) cut the insertions by ~12% on the LIO data
// and measured slower than it saved; it is not here.
// The split is static and there are no atomics, so a launch is
// deterministic to the bit. No tensor cores: the distance is fp32 FFMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ref_steps.cuh"

namespace cg = cooperative_groups;
using namespace bst;

namespace {

constexpr int kEmpty = 0x7fffffff;

// (d, i) before (e, j) in the order of the result
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert (d, i) into the sorted list, where i is above every index in it:
// slot j takes slot j-1's entry, or the new one at the first slot it beats.
template <int K>
__device__ __forceinline__ void insert_next(float (&bd)[K], int (&bi)[K],
                                            float d, int i) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool here = d < bd[j], shift = d < bd[j - 1];
    if (here) {
      bd[j] = shift ? bd[j - 1] : d;
      bi[j] = shift ? bi[j - 1] : i;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

// The same for an entry of another list: ties compare indices.
template <int K>
__device__ __forceinline__ void insert_any(float (&bd)[K], int (&bi)[K],
                                           float d, int i) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool here = before(d, i, bd[j], bi[j]);
    const bool shift = before(d, i, bd[j - 1], bi[j - 1]);
    if (here) {
      bd[j] = shift ? bd[j - 1] : d;
      bi[j] = shift ? bi[j - 1] : i;
    }
  }
  if (before(d, i, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = i;
  }
}

// Take in a sorted list of QT-strided entries (d at ld, index at li) until
// its first entry that loses to the k-th.
template <int K>
__device__ __forceinline__ void take_in(float (&bd)[K], int (&bi)[K],
                                        const float* ld, const int* li) {
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const float d = ld[j * QT];
    const int i = li[j * QT];
    if (!before(d, i, bd[K - 1], bi[K - 1])) break;
    insert_any(bd, bi, d, i);
  }
}

template <int K>
union Smem {
  Staged scan[W];        // each warp's staged steps
  struct {
    float ld[W][K][QT];  // lists for the merge: warps 1..W-1 of this CTA,
    int li[W][K][QT];    // slot 0 its merged list for rank 0
  } merge;
};

template <int K>
__global__ void __launch_bounds__(NT)
knn_topk_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                const bool* __restrict__ ref_valid,
                int64_t* __restrict__ out_idx, float* __restrict__ out_d2,
                int Q, int R) {
  __shared__ Smem<K> sm;
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

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = kEmpty;
  }
  // a ref enters where d < thr: the k-th distance; never for a lane past Q
  float thr = active ? CUDART_INF_F : -CUDART_INF_F;

  Staged& st = sm.scan[warp];
  const int P = S * W;
  const int steps = (R + T - 1) / T;
  for (int g0 = rank * W + warp; g0 < steps; g0 += B * P) {
    stage_steps(ref, ref_valid, R, g0, P, lane, st);
    for (int b = 0; b < B; ++b) {
      const int n = st.n[b];
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float4 r = st.ref[b][t];
        const float d = qq + r.w - 2.0f * (qx * r.x + qy * r.y + qz * r.z);
        if (d < thr) {
          insert_next(bd, bi, d, st.idx[b][t]);
          thr = bd[K - 1];
        }
      }
    }
  }
  __syncthreads();  // the staging buffers become the merge buffers

  // merge the CTA's W lists into warp 0's
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sm.merge.ld[warp][j][lane] = bd[j];
      sm.merge.li[warp][j][lane] = bi[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < W; ++w)
      take_in(bd, bi, &sm.merge.ld[w][0][lane], &sm.merge.li[w][0][lane]);
  }
  // merge the cluster's S lists into rank 0's
  if (S > 1) {
    if (warp == 0 && rank > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        sm.merge.ld[0][j][lane] = bd[j];
        sm.merge.li[0][j][lane] = bi[j];
      }
    }
    cluster.sync();
    if (warp == 0 && rank == 0) {
      for (int r = 1; r < S; ++r) {
        const float* ld = cluster.map_shared_rank(&sm.merge.ld[0][0][0], r);
        const int* li = cluster.map_shared_rank(&sm.merge.li[0][0][0], r);
        take_in(bd, bi, ld + lane, li + lane);
      }
    }
    cluster.sync();  // rank 0 has read every rank's list
  }

  if (warp == 0 && rank == 0 && active) {
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
                   float* d2, int Q, int R, int S, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config((Q + QT - 1) / QT, S, stream, &attr);
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, knn_topk_kernel<K>, q, r, v, idx, d2, Q, R);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// How many clusters of S CTAs of the kernel (at k = 10, the most registers)
// the current device can hold at once; 0 where it cannot schedule that size.
extern "C" int bst_knn_max_active_clusters(int S) {
  return max_active_clusters(knn_topk_kernel<10>, S);
}

// Plain C interface (loaded with ctypes). query [Q,3] f32, ref [R,3] f32,
// ref_valid [R] bool, all contiguous on the device; writes idx [Q,k] int64
// and d2 [Q,k] f32. One cluster of `cluster` CTAs (1, 2, 4 or 8) per 32
// queries. k must be one of 1, 5, 8, 10 (the repo's callers); any other k,
// Q < 1 or R < 1 returns cudaErrorInvalidValue without launching.
extern "C" int bst_knn_topk_f32(const void* query, const void* ref,
                                const void* ref_valid, void* out_idx,
                                void* out_d2, int Q, int R, int k,
                                int cluster, void* stream) {
  if (Q < 1 || R < 1 || !valid_cluster(cluster))
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  const bool* v = static_cast<const bool*>(ref_valid);
  int64_t* idx = static_cast<int64_t*>(out_idx);
  float* d2 = static_cast<float*>(out_d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(q, r, v, idx, d2, Q, R, cluster, s);
    case 5: return (int)launch<5>(q, r, v, idx, d2, Q, R, cluster, s);
    case 8: return (int)launch<8>(q, r, v, idx, d2, Q, R, cluster, s);
    case 10: return (int)launch<10>(q, r, v, idx, d2, Q, R, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
