// The grid that K2 (knn.cu) and K3 (moments.cu) share, and how a warp
// stages its refs.
//
// A thread-block cluster of S CTAs (S in {1, 2, 4, 8}) takes a tile of
// QT = 32 queries, one a lane; each CTA has W = 8 warps. R is cut into steps
// of T = 64 refs, dealt round-robin to the S*W warps of the cluster (step g
// to warp g mod S*W), so that the valid refs, wherever they lie, spread
// evenly over the warps. A warp stages B = 4 of its steps at once: each lane
// takes two refs of each, loads the valid flags of all eight together and
// then the coordinates of the valid ones together, so that the warp waits
// two L2 round trips per B steps and reads no coordinate of an invalid
// ref; a ballot compacts each step's valid refs, packed as float4 (x, y, z,
// ||r||^2), into the warp's own slice of shared memory in ascending index.
// Invalid refs are never scanned.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace bst {

constexpr int QT = 32;       // queries per cluster, one a lane
constexpr int W = 8;         // warps per CTA
constexpr int NT = 32 * W;   // threads per CTA
constexpr int T = 64;        // refs per step, two a lane
constexpr int B = 4;         // steps a warp stages at once
constexpr unsigned FULL = 0xffffffffu;

// A warp's staged steps in shared memory.
struct Staged {
  float4 ref[B][T];  // each step's valid refs, packed, in index order
  int idx[B][T];     // ... their indices
  int n[B];          // ... how many
};

// Stage the warp's steps g0, g0 + P, ..., g0 + (B-1)P (P = S*W) into `st`.
// Returns how many refs of them lie in [0, R) and are invalid (the same in
// every lane).
__device__ __forceinline__ int stage_steps(const float* __restrict__ ref,
                                           const bool* __restrict__ ref_valid,
                                           int R, int g0, int P, int lane,
                                           Staged& st) {
  // the flags of all B steps in flight at once, then the coordinates of
  // the valid refs among them: two L2 round trips per B steps, and no
  // coordinate of an invalid ref read
  bool ok[B][2];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (g0 + b * P) * T + h * 32 + lane;
      ok[b][h] = r < R && ref_valid[r];
    }
  }
  float x[B][2], y[B][2], z[B][2];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (g0 + b * P) * T + h * 32 + lane;
      x[b][h] = y[b][h] = z[b][h] = 0.f;
      if (ok[b][h]) {
        x[b][h] = ref[3 * r + 0];
        y[b][h] = ref[3 * r + 1];
        z[b][h] = ref[3 * r + 2];
      }
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int invalid = 0;
  __syncwarp();  // the previous batch is no longer read
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const unsigned m0 = __ballot_sync(FULL, ok[b][0]);
    const unsigned m1 = __ballot_sync(FULL, ok[b][1]);
    const int n0 = __popc(m0), n = n0 + __popc(m1);
    const int first = (g0 + b * P) * T;
    invalid += max(min(R - first, T), 0) - n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ok[b][h]) {
        const int s = h == 0 ? __popc(m0 & below) : n0 + __popc(m1 & below);
        st.ref[b][s] = make_float4(
            x[b][h], y[b][h], z[b][h],
            x[b][h] * x[b][h] + y[b][h] * y[b][h] + z[b][h] * z[b][h]);
        st.idx[b][s] = first + h * 32 + lane;
      }
    }
    if (lane == 0) st.n[b] = n;
  }
  __syncwarp();
  return invalid;
}

// Launch configuration of a cluster kernel: `clusters` clusters of S CTAs.
inline cudaLaunchConfig_t launch_config(int clusters, int S,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * (unsigned)S, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

inline bool valid_cluster(int S) {
  return S >= 1 && S <= 8 && (S & (S - 1)) == 0;
}

// How many clusters of S CTAs of `kernel` the current device can hold at
// once; 0 where it cannot schedule that size at all.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int S) {
  if (!valid_cluster(S)) return 0;
  int n = 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, S, nullptr, &attr);
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // the refusal is the answer; leave no error behind
    return 0;
  }
  return n;
}

}  // namespace bst
