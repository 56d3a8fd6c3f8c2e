// Batched dense Cholesky factor + solve for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel beam_slam_tpu/ops/pallas_cholesky.py ::
// cholesky_solve_batched (body _chol_solve_kernel): x = H⁻¹ g for B damped,
// Jacobi-equilibrated SPD systems H [B, N, N], g [B, N], f32. On the LM path
// this is the reduced camera system of every iteration, after the caller's
// 128-padding: N = 640 for the flagship window, N = 1024 for the fixed-lag
// smoother at configs/lio.yaml's capacities (990 dof + the trash dof);
// B = 1 for a single window's solve and 8–64 for batched refinement.
//
// What bounds it on this card: not bytes (1.6 MB per system) and not the
// 87 MFLOP of a 640² factor, but the dependency chain. A blocked Cholesky is
// N/32 panel steps; each needs the 32×32 diagonal tile factored — 32 pivots
// one after another, each a broadcast, a reciprocal square root and a
// rank-1 update — before its panel can be solved, and the panel before the
// trailing matrix can be updated, which holds the next tile. With few
// systems most of the card's 132 SMs have nothing to do unless one system is
// spread over several of them, and then every hand-over between SMs goes
// through L2.
//
// Design: one thread-block cluster of C CTAs (C ∈ {1, 2, 4, 8, 16}, 256
// threads each) factors and solves one system; CTA b·C + r is rank r of
// system b. The matrix lives in a scratch copy in global memory (1.6 MB at
// N = 640: resident in the 50 MB L2, far above one SM's 227 KB of shared
// memory) and is staged through shared memory tile by tile. The cluster's
// hardware barrier orders the phases of a panel step. Rank 0 runs
// the chain of tile factors one panel ahead of the others' trailing update,
// so that the O(N³) update hides behind it (or it behind the update):
//   0. rank 0 factors the first diagonal tile in one warp — lane i holds row
//      i in registers, the pivot column goes round by __shfl_sync, no block
//      barrier per column — carrying L_kk⁻¹ along on the same broadcasts, and
//      publishes L_00⁻¹ (over the tile, in the scratch copy), y_0 = L_00⁻¹ g_0
//      (over g_0) and, on a bad pivot, its index (in info);
// then per 32-wide panel k, between two cluster barriers each:
//   1. the other ranks fetch L_kk⁻¹ and y_k; every rank reads the same info,
//      so a bad pivot ends the loop at the same step in every rank and no
//      rank waits at a barrier that the others skipped;
//   2. the 32-row blocks below the tile are dealt round-robin to the ranks;
//      with the inverse the panel solve is a dense product L_p = P·L_kk⁻ᵀ
//      with no serial chain. g rides along as one more row: the block's
//      owner also takes g_p −= L_p y_k, so forward substitution costs no
//      pass of its own. Block 0, the rows of the next diagonal tile, is
//      rank 0's;
//   3. rank 0 arrives at the barrier and, before it waits, looks ahead: the
//      next diagonal tile less L0·L0ᵀ has all of its update, so rank 0
//      factors it now (a spare warp takes g_{k+1} = g − L0·y_k beside it) and
//      publishes L⁻¹, y and the verdict for step k+1;
//   4. meanwhile the others take the rank-32 update of the trailing LOWER
//      triangle in 64×64 tiles dealt round-robin, both 64×32 panel blocks
//      staged once per tile (transposed and swizzled, read back as float4),
//      the next tile's blocks fetched under the product, a 4×4 register
//      tile per thread, fp32 FFMA. Rank 0 joins with a share that is short
//      by what its look-ahead costs.
// Rank 0 then runs the backward substitution Lᵀx = y, each block step two
// small mat-vecs with the stored L_kk⁻¹. The split is static and there are
// no atomics, so a launch is deterministic to the bit. The upper triangle
// of H is never read. Data that another rank wrote is read with __ldcg (L2,
// never a stale L1 line or the read-only path).
//
// No tensor cores: wgmma has no fp32 input type, and its nearest, TF32, keeps
// about three decimal digits, which the solver's numerics rule forbids.
//
// A non-positive (or non-finite) pivot is NOT clamped, unlike the TPU
// kernel's 1e-20 floor: info[b] gets the 1-based index of the first bad
// pivot and x[b] is filled with NaN, which is what the XLA cholesky path
// gives the reference's single-window solve and what its step gate tests.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the scratch buffer, the cluster size and the stream, and checks the
// returned launch error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cholesky_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int UT = 64;       // trailing-update tile
constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int BW = 16;       // rows a lane fetches at once, backward pass

// The two halves of cluster.sync(): a rank that has arrived may go on with
// work of its own and wait later; the others pass once every rank has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// (ti, tl), tl ≤ ti, of the t-th tile of a lower triangle counted row by row.
__device__ __forceinline__ void tile_of(int t, int* ti, int* tl) {
  int i = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *ti = i;
  *tl = t - i * (i + 1) / 2;
}

// A 64-row, 32-column panel block staged for the update: element (i, j) at
// U[j][(i/4) ^ (j%8)], component i%4 — transposed, so a thread reads its four
// rows as one float4, and swizzled, so neither the transposing stores nor the
// reads collide on a bank.
struct PanelRegs { float v[UT * TB / NT]; };

__device__ __forceinline__ void panel_load(PanelRegs* r, const float* A, int N,
                                           int row0, int nrows, int k0, int kb,
                                           int warp, int lane) {
#pragma unroll
  for (int it = 0; it < UT * TB / NT; ++it) {
    const int u = warp + NW * it;  // a unit: 4 rows × 8 columns, one warp
    const int i = (u >> 2) * 4 + (lane & 3), j = (u & 3) * 8 + (lane >> 2);
    r->v[it] = (i < nrows && j < kb)
                   ? __ldcg(&A[(size_t)(row0 + i) * N + k0 + j]) : 0.f;
  }
}

__device__ __forceinline__ void panel_store(const PanelRegs& r,
                                            float4 (*U)[UT / 4], int warp,
                                            int lane) {
#pragma unroll
  for (int it = 0; it < UT * TB / NT; ++it) {
    const int u = warp + NW * it;
    const int q = u >> 2, j = (u & 3) * 8 + (lane >> 2);
    reinterpret_cast<float*>(&U[j][q ^ (j & 7)])[lane & 3] = r.v[it];
  }
}

// One warp factors the staged 32×32 tile T (row-major, lower, padded with the
// identity) and carries L⁻¹ along: lane i holds row i of the tile and column
// i of the inverse in registers, the pivot column goes round by __shfl_sync.
// Writes X = L⁻¹; returns 0 or the 1-based column of the first bad pivot.
__device__ __forceinline__ int factor_invert_tile(const float (*T)[LD],
                                                  float (*X)[LD], int lane) {
  float a[TB];  // row `lane` of the tile, then of L
  float w[TB];  // column `lane` of L⁻¹
#pragma unroll
  for (int g = 0; g < TB / 4; ++g) {
    const float4 t = ld4(T[lane], g);
    a[4 * g] = t.x, a[4 * g + 1] = t.y, a[4 * g + 2] = t.z, a[4 * g + 3] = t.w;
  }
#pragma unroll
  for (int l = 0; l < TB; ++l) w[l] = (l == lane) ? 1.f : 0.f;
  // Right-looking, one column at a time. Lane j+1 holds all of the next
  // pivot, a[j+1][j+1] − L[j+1][j]², as soon as 1/L[j][j] is known: it is
  // sent round and its reciprocal square root taken while the column's
  // updates are still under way.
  float d = __shfl_sync(FULL, a[0], 0);  // the same in all lanes
  int bad = bad_pivot(d) ? 1 : 0;
  float inv = rsqrt_refined(d);
#pragma unroll
  for (int j = 0; j < TB; ++j) {
    if (bad == 0) {
      const float lj = a[j] * inv;
      float d_next = 1.f;
      if (j + 1 < TB)
        d_next = __shfl_sync(FULL, __fmaf_rn(-lj, lj, a[j + 1]), j + 1);
      a[j] = (lane > j) ? lj : (lane == j ? d * inv : 0.f);
      const float xj = w[j] * inv;  // L⁻¹[j][lane]
      w[j] = xj;
      if (bad_pivot(d_next)) bad = j + 2;
      d = d_next;
      inv = rsqrt_refined(d_next);
#pragma unroll
      for (int l = j + 1; l < TB; ++l) {
        const float v = __shfl_sync(FULL, a[j], l);  // L[l][j]
        a[l] = __fmaf_rn(-a[j], v, a[l]);
        w[l] = __fmaf_rn(-v, xj, w[l]);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < TB; ++l) X[l][lane] = w[l];
  return bad;
}

// One warp: lane i returns row i of the 32×32 matrix M times the vector v.
__device__ __forceinline__ float tile_matvec(const float (*M)[LD],
                                             const float* v, int lane) {
  float y = 0.f;
#pragma unroll
  for (int g = 0; g < TB / 4; ++g) {
    const float4 m = ld4(M[lane], g), u = ld4(v, g);
    y += m.x * u.x + m.y * u.y + m.z * u.z + m.w * u.w;
  }
  return y;
}

// P·Qᵀ of two staged 32×32 blocks: thread (warp, lane) gets the entries
// (warp + 8q, lane), q = 0..3, in acc.
__device__ __forceinline__ void block_abt(const float (*P)[LD],
                                          const float (*Q)[LD], int warp,
                                          int lane, float* acc) {
#pragma unroll
  for (int q = 0; q < TB / NW; ++q) acc[q] = 0.f;
#pragma unroll
  for (int g = 0; g < TB / 4; ++g) {
    const float4 c = ld4(Q[lane], g);
#pragma unroll
    for (int q = 0; q < TB / NW; ++q) {
      const float4 r = ld4(P[warp + NW * q], g);
      acc[q] += r.x * c.x + r.y * c.y + r.z * c.z + r.w * c.w;
    }
  }
}

// Rank 0 publishes what it made of the diagonal tile at k0: L_kk⁻¹ over the
// tile's lower triangle in the scratch copy (the backward substitution reads
// it there too) and y_k over g_k — or the index of the bad pivot.
__device__ __forceinline__ void publish_tile(float* A, float* x, int* info,
                                             int N, int k0, int kb,
                                             const float (*X)[LD],
                                             const float* ys, int bad,
                                             int tid) {
  if (bad != 0) {
    if (tid == 0) *info = bad;
    return;
  }
  for (int e = tid; e < TB * TB; e += NT) {
    const int i = e / TB, j = e % TB;
    if (i < kb && j <= i) A[(size_t)(k0 + i) * N + k0 + j] = X[i][j];
  }
  if (tid < kb) x[k0 + tid] = ys[tid];
}

__global__ void __launch_bounds__(NT)
chol_solve_cluster_kernel(const float* __restrict__ H,
                          const float* __restrict__ g, float* A_all,
                          float* x_all, int* info_all, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t NN = (size_t)N * N;
  const float* Hb = H + (size_t)b * NN;
  float* A = A_all + (size_t)b * NN;  // written by every rank: no __restrict__
  float* x = x_all + (size_t)b * N;   // g, then y, then x
  // rows of A start on 16 bytes: the update moves its tiles as float4
  const bool vec = (N % 4 == 0) && (reinterpret_cast<size_t>(A_all) % 16 == 0);

  // L_kk⁻¹ (lower triangular); a staged panel block, or the tile to factor;
  // rank 0: the panel's first block, solved
  __shared__ __align__(16) float Xs[TB][LD];
  __shared__ __align__(16) float Pa[TB][LD];
  __shared__ __align__(16) float L0[TB][LD];
  // the update's row and column panel blocks, double-buffered
  __shared__ __align__(16) float4 U[2][2][TB][UT / 4];
  __shared__ __align__(16) float gs[TB];
  __shared__ __align__(16) float ys[TB];
  __shared__ float red[NW][TB];
  __shared__ int s_info;  // rank 0: 1-based index of the first bad pivot

  // scratch ← lower triangle of H, x ← g, rows dealt to the cluster's warps
  for (int i = rank * NW + warp; i < N; i += C * NW) {
    const float* src = Hb + (size_t)i * N;
    float* dst = A + (size_t)i * N;
    for (int j = lane; j <= i; j += 32) dst[j] = src[j];
  }
  for (int e = rank * NT + tid; e < N; e += C * NT)
    x[e] = g[(size_t)b * N + e];
  if (tid == 0) {
    s_info = 0;
    if (rank == 0) info_all[b] = 0;
  }
  cluster.sync();

  // Rank 0 factors the first diagonal tile and publishes L_00⁻¹ and y_0.
  if (rank == 0) {
    const int kb = min(TB, N);
#pragma unroll
    for (int q = 0; q < TB / NW; ++q) {
      const int i = warp + NW * q;
      Pa[i][lane] = (i < kb && lane <= i) ? __ldcg(&A[(size_t)i * N + lane])
                                          : (i == lane ? 1.f : 0.f);
    }
    if (tid < TB) gs[tid] = (tid < kb) ? __ldcg(&x[tid]) : 0.f;
    __syncthreads();
    if (warp == 0) {
      const int bad = factor_invert_tile(Pa, Xs, lane);
      if (bad != 0 && lane == 0) s_info = bad;
      __syncwarp();
      ys[lane] = tile_matvec(Xs, gs, lane);
    }
    __syncthreads();
    publish_tile(A, x, info_all + b, N, 0, kb, Xs, ys, s_info, tid);
  }
  cluster.sync();

  // ---------------- factor, and forward substitution with it ----------------
  int bad = 0;
  for (int k0 = 0; k0 < N; k0 += TB) {
    const int kb = min(TB, N - k0);
    const int r0 = k0 + kb;
    // the verdict on tile k: rank 0 reached it, the others read what it
    // published before the last barrier — the same value in every rank
    bad = (rank == 0) ? s_info : __ldcg(&info_all[b]);
    if (bad != 0 || r0 >= N) break;  // r0 ≥ N: last panel, nothing below it

    // 1. rank 0 holds L_kk⁻¹ and y_k from its look-ahead and starts fetching
    //    the next diagonal tile; the others fetch what rank 0 published
    const int kbn = min(TB, N - r0);
    float tv[TB / NW];  // rank 0: the next tile as it stands; others: L_kk⁻¹
#pragma unroll
    for (int q = 0; q < TB / NW; ++q) {
      const int i = warp + NW * q;
      if (rank == 0) {
        tv[q] = (i < kbn && lane <= i)
                      ? __ldcg(&A[(size_t)(r0 + i) * N + r0 + lane]) : 0.f;
      } else {
        tv[q] = (i < kb && lane <= i)
                      ? __ldcg(&A[(size_t)(k0 + i) * N + k0 + lane]) : 0.f;
      }
    }
    if (rank != 0) {
      const float yk = (tid < kb) ? __ldcg(&x[k0 + tid]) : 0.f;
#pragma unroll
      for (int q = 0; q < TB / NW; ++q) Xs[warp + NW * q][lane] = tv[q];
      if (tid < TB) ys[tid] = yk;
    }

    // 2. panel solve L_p = P·L_kk⁻ᵀ on this rank's 32-row blocks, and
    //    g_p −= L_p y_k. The blocks are dealt so that block 0, the rows of
    //    the next diagonal tile, is rank 0's, which takes it first and keeps
    //    it in shared memory for its look-ahead: rank r has blocks
    //    (C − r) mod C, + C, + 2C, …
    const int npb = (N - r0 + TB - 1) / TB;
    for (int p = (C - rank) % C; p < npb; p += C) {
      const int rb = r0 + p * TB;
      const int rn = min(TB, N - rb);
      float pv[TB / NW], gv[TB / NW];
#pragma unroll
      for (int q = 0; q < TB / NW; ++q) {
        const int i = warp + NW * q;
        pv[q] = (i < rn && lane < kb)
                    ? __ldcg(&A[(size_t)(rb + i) * N + k0 + lane]) : 0.f;
        gv[q] = (i < rn && lane == 0 && !(rank == 0 && p == 0))
                    ? __ldcg(&x[rb + i]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < TB / NW; ++q) Pa[warp + NW * q][lane] = pv[q];
      __syncthreads();
      float acc[TB / NW];
      block_abt(Pa, Xs, warp, lane, acc);
#pragma unroll
      for (int q = 0; q < TB / NW; ++q) {
        const int i = warp + NW * q;
        if (i < rn && lane < kb) A[(size_t)(rb + i) * N + k0 + lane] = acc[q];
        if (rank == 0 && p == 0) {
          // the look-ahead keeps the block; a spare warp takes its g rows
          // from it while the next tile is factored
          L0[i][lane] = acc[q];
        } else {
          float s = acc[q] * ys[lane];
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
          if (lane == 0 && i < rn) x[rb + i] = gv[q] - s;
        }
      }
      __syncthreads();  // Pa free
    }

    // 3. the panel is complete. Rank 0 says so and, before it waits for the
    //    others, looks ahead: the next diagonal tile less L0·L0ᵀ is all of
    //    that tile's update, so it is factored now, while the others update
    //    the trailing matrix, and published for the next step.
    if (rank == 0) {
      cluster_arrive();
      float upd[TB / NW];
      block_abt(L0, L0, warp, lane, upd);
#pragma unroll
      for (int q = 0; q < TB / NW; ++q) {
        const int i = warp + NW * q;
        Pa[i][lane] = (i < kbn && lane <= i) ? tv[q] - upd[q]
                                             : (i == lane ? 1.f : 0.f);
      }
      __syncthreads();
      if (warp == 0) {
        const int bad_next = factor_invert_tile(Pa, Xs, lane);
        if (bad_next != 0 && lane == 0) s_info = r0 + bad_next;
      } else if (warp == 1) {  // g_{k+1} = g − L0·y_k, beside the factor
        const float gi = (lane < kbn) ? __ldcg(&x[r0 + lane]) : 0.f;
        gs[lane] = gi - tile_matvec(L0, ys, lane);
      }
      __syncthreads();
      if (warp == 0) ys[lane] = tile_matvec(Xs, gs, lane);
      __syncthreads();
      publish_tile(A, x, info_all + b, N, r0, kbn, Xs, ys, s_info, tid);
      cluster_wait();
    } else {
      cluster.sync();
    }

    // 4. trailing update of the lower triangle in 64×64 tiles: thread
    //    (ty, tx) owns rows 4ty.., columns 4tx.. of a tile. Rank 0 takes the
    //    last n0 tiles, fewer than a full share by what its look-ahead costs
    //    (about 2.5 tiles); the others share the rest. The next tile's panel
    //    blocks are fetched into registers while this one is computed.
    //    Diagonal tiles are updated whole: what lands above the diagonal of
    //    the scratch copy is never read. The first 32 rows are the next
    //    diagonal tile, which rank 0 has taken.
    const int ntile = (N - r0 + UT - 1) / UT;
    const int total = ntile * (ntile + 1) / 2;
    const int n0 = (C == 1) ? total
                            : max(0, (2 * total - 5 * (C - 1)) / (2 * C));
    const int t_end = (rank == 0) ? total : total - n0;
    const int t_step = (rank == 0) ? 1 : C - 1;
    const int ty = tid / 16, tx = tid % 16;
    PanelRegs pa, pb;
    int ti, tl, buf = 0;
    int t = (rank == 0) ? total - n0 : rank - 1;
    if (t < t_end) {
      tile_of(t, &ti, &tl);
      panel_load(&pa, A, N, r0 + ti * UT, N - r0 - ti * UT, k0, kb, warp, lane);
      panel_load(&pb, A, N, r0 + tl * UT, N - r0 - tl * UT, k0, kb, warp, lane);
      panel_store(pa, U[0][0], warp, lane);
      panel_store(pb, U[0][1], warp, lane);
    }
    __syncthreads();
    for (; t < t_end; t += t_step) {
      const int ri = r0 + ti * UT + 4 * ty, rl = r0 + tl * UT + 4 * tx;
      const bool more = t + t_step < t_end;
      if (more) {
        tile_of(t + t_step, &ti, &tl);
        panel_load(&pa, A, N, r0 + ti * UT, N - r0 - ti * UT, k0, kb, warp,
                   lane);
        panel_load(&pb, A, N, r0 + tl * UT, N - r0 - tl * UT, k0, kb, warp,
                   lane);
      }
      const bool mine = ri >= r0 + TB && ri < N && rl < N;  // ri % 4 == 0
      float old[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* row = A + (size_t)(ri + p) * N + rl;
        if (vec) {
          const float4 o = mine ? __ldcg(reinterpret_cast<const float4*>(row))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          old[p][0] = o.x, old[p][1] = o.y, old[p][2] = o.z, old[p][3] = o.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            old[p][c] = (mine && ri + p < N && rl + c < N) ? __ldcg(row + c)
                                                           : 0.f;
        }
      }
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;
#pragma unroll 8
      for (int j = 0; j < TB; ++j) {
        const float4 a4 = U[buf][0][j][ty ^ (j & 7)];
        const float4 c4 = U[buf][1][j][tx ^ (j & 7)];
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[p][c] += av[p] * cv[c];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float* row = A + (size_t)(ri + p) * N + rl;
        if (vec) {
          if (mine)
            *reinterpret_cast<float4*>(row) =
                make_float4(old[p][0] - acc[p][0], old[p][1] - acc[p][1],
                            old[p][2] - acc[p][2], old[p][3] - acc[p][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (mine && ri + p < N && rl + c < N)
              row[c] = old[p][c] - acc[p][c];
        }
      }
      if (more) {
        panel_store(pa, U[buf ^ 1][0], warp, lane);
        panel_store(pb, U[buf ^ 1][1], warp, lane);
      }
      __syncthreads();
      buf ^= 1;
    }

    // 5. the trailing matrix is complete, and the next tile's L⁻¹, y and
    //    verdict are published
    cluster.sync();
  }

  if (bad != 0) {  // x[b] ← NaN; the other systems are other clusters
    if (rank == 0)
      for (int e = tid; e < N; e += NT) x[e] = nanf("");
    return;
  }
  if (rank != 0) return;

  // ---------------- backward substitution: x ← L⁻ᵀ y, rank 0 ----------------
  // x_k = L_kk⁻ᵀ (y_k − Σ_{m>k} L_mkᵀ x_m), blocks from the last up. A trip to
  // L2 is what a step costs, so every load of a step is issued before the
  // first of them is used: from addresses clamped into the matrix, masked
  // afterwards, the stores to shared memory last.
  const int nblk = (N + TB - 1) / TB;
  for (int kbi = nblk - 1; kbi >= 0; --kbi) {
    const int k0 = kbi * TB;
    const int kb = min(TB, N - k0);
    const int r0 = k0 + kb;
    __syncthreads();  // x of the blocks below is final; Xs, red free
    float xt[TB / NW];
#pragma unroll
    for (int q = 0; q < TB / NW; ++q)
      xt[q] = __ldcg(&A[(size_t)min(k0 + warp + NW * q, N - 1) * N +
                        min(k0 + lane, N - 1)]);
    const float yk = __ldcg(&x[min(k0 + lane, N - 1)]);
    // Σ_m L[m, k0+lane]·x[m] over the rows below, dealt to the warps
    float s = 0.f;
    const int nrows = N - r0;  // kb = 32 where there are any
    const float* col = A + (size_t)r0 * N + k0 + lane;
    for (int base = warp; base < nrows; base += BW * NW) {
      float lv[BW], xv[BW];
#pragma unroll
      for (int u = 0; u < BW; ++u) {  // 2·BW loads in flight
        const int m = min(base + u * NW, nrows - 1);
        lv[u] = __ldcg(&col[(size_t)m * N]);
        xv[u] = __ldcg(&x[r0 + m]);
      }
#pragma unroll
      for (int u = 0; u < BW; ++u)
        s += (base + u * NW < nrows) ? lv[u] * xv[u] : 0.f;
    }
    red[warp][lane] = s;
#pragma unroll
    for (int q = 0; q < TB / NW; ++q) {
      const int i = warp + NW * q;
      Xs[i][lane] = (i < kb && lane <= i) ? xt[q] : 0.f;
    }
    __syncthreads();
    if (warp == 0) {
      float v = (lane < kb) ? yk : 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) v -= red[q][lane];
      gs[lane] = v;
      __syncwarp();
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < TB; ++i) z += Xs[i][lane] * gs[i];
      if (lane < kb) x[k0 + lane] = z;
    }
  }
}

cudaLaunchConfig_t launch_config(int clusters, int C, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * (unsigned)C, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cluster(int C) { return C >= 1 && C <= 16 && (C & (C - 1)) == 0; }

// Sizes above 8 are non-portable: the kernel must opt in.
cudaError_t allow_cluster(int C) {
  if (C <= 8) return cudaSuccess;
  return cudaFuncSetAttribute(chol_solve_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

}  // namespace

// How many clusters of C CTAs of this kernel the current device can hold at
// once; 0 where it cannot schedule that size at all.
extern "C" int bst_cholesky_max_active_clusters(int C) {
  if (!valid_cluster(C)) return 0;
  int n = 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, C, nullptr, &attr);
  cudaError_t err = allow_cluster(C);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, chol_solve_cluster_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is the answer; leave no error behind
    return 0;
  }
  return n;
}

// H [B,N,N] (lower triangle read), g [B,N] inputs (read only); scratch
// [B,N,N] receives L with L_kk⁻¹ in its diagonal tiles; x [B,N] the solution;
// info [B] int32. All device pointers, row-major, contiguous. One cluster of
// `cluster` CTAs (1, 2, 4, 8 or 16) per system. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int bst_cholesky_solve_batched_f32(const float* H, const float* g,
                                              float* scratch, float* x,
                                              int* info, int B, int N,
                                              int cluster, void* stream) {
  if (B < 1 || N < 1 || !valid_cluster(cluster))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_cluster(cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(B, cluster, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, chol_solve_cluster_kernel, H, g, scratch, x,
                           info, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
