// K1's grid schedule: dense Cholesky factor + solve of FEW LARGE systems on
// the whole card, for Hopper (sm_90a), plain C ABI.
//
// Replaces, with cholesky.cu, the TPU kernel
// beam_slam_tpu/ops/pallas_cholesky.py :: cholesky_solve_batched: x = H⁻¹ g
// for damped, equilibrated SPD systems H [B, N, N], g [B, N], f32.
// cholesky.cu puts one thread-block cluster of at most 16 CTAs on each
// system, which suits many systems, or small ones; one system of N = 2048
// (LVIO's 128-state smoother, the global graph) or N = 6000 (a 1000-keyframe
// pose graph) would then have 16 of the card's 132 SMs. Here every system
// has the whole card, one after another.
//
// What bounds it: at N = 6000 the trailing update, N³/3 FLOPs and, per panel
// step, a pass over the trailing triangle in device memory; at N ≤ 2048 the
// chain of N/NB panel steps, each two grid barriers, a panel solve and the
// factor of one NB×NB diagonal block by one CTA.
//
// Design: a blocked right-looking Cholesky in panels of NB = 64 columns (128
// was slower at every N measured: its one-CTA block factor costs more than
// the steps it saves), one cooperative launch of one CTA per SM (GT = 256
// threads), its phases separated by grid barriers (cg::this_grid().sync();
// one launch a phase was slower at N = 2048), the systems of a batch one
// after another:
//   init    CTA 0 factors the first diagonal block straight from H while
//           the others copy H's lower triangle into the scratch copy and g
//           into the work vector w;
//   panel k the rows below the diagonal block in blocks of RB = 32 rows,
//           dealt round-robin: with L_kk⁻¹ the panel solve is a product
//           L_ik = A_ik·L_kk⁻ᵀ, and g rides along as one more row
//           (w_i −= L_ik·y_k), so forward substitution costs no pass of its
//           own. L_ik goes to the scratch copy and, transposed, to the panel
//           buffer Pt, whence the update stages it with cp.async;
//   update k look-ahead: CTA 0 takes the next diagonal block's share of the
//           update itself (D −= P·Pᵀ, P its rows of the panel) and factors
//           the block, while the others update the rest of the trailing
//           LOWER triangle in 128×128 tiles, dealt statically (no atomics:
//           two launches give the same bits), both 128×NB panel blocks
//           staged in chunks of 32 columns with cp.async, double-buffered,
//           the tile's old values fetched under the last chunk, an 8×8
//           register tile per thread, fp32 FFMA;
//   back m  x_m = L_mm⁻ᵀ y_m from the stored inverse (every CTA that needs it
//           computes it), then y_j −= L_mjᵀ x_m for every j < m, the columns
//           dealt to the CTAs in chunks of 32: one barrier a block.
// The diagonal block is factored in one CTA's shared memory one 32-wide
// sub-panel at a time: its 32×32 tile factored and inverted by the whole CTA
// four columns a barrier (factor_invert_tile_cta), the tiles below solved by
// product with that inverse and the rest of the block updated; then L_kk⁻¹
// is assembled from the tiles' inverses, (L⁻¹)_ts = −L_tt⁻¹ Σ_u L_tu (L⁻¹)_us,
// by distance from the diagonal. The scratch copy ends with L below the
// diagonal blocks and L_kk⁻¹ in them; its upper triangle is never read, nor
// is H's.
//
// A non-positive (or non-finite) pivot is not clamped: info[b] gets the
// 1-based index of the first bad pivot and x[b] is NaN. Only CTA 0 writes
// info, and only while it is 0; the backward pass reads it once per CTA
// after a barrier. Every CTA passes every barrier, bad pivot or not, so none
// can wait for one that another skipped; what the phases compute after a
// bad pivot is discarded.
//
// No tensor cores (TF32 keeps about three decimal digits, which the solver's
// numerics rule forbids). The kernel allocates nothing and does not
// synchronise: the caller passes the scratch copy, the work buffer
// (bst_cholesky_grid_work_floats), the CTA count (bst_cholesky_grid_ctas,
// queried once a device) and the stream, and checks the returned launch
// error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cholesky_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GT = 256;         // threads per CTA
constexpr int GW = GT / 32;     // warps per CTA
constexpr int UT2 = 128;        // trailing-update tile
constexpr int KC = 32;          // columns of a staged update chunk
constexpr int RB = 32;          // rows of a panel-solve block
constexpr int HDR = 16;         // floats of dynamic shared memory for flags
constexpr int NB = 64;          // panel width: the diagonal block is NB×NB

struct Args {
  const float* H;  // [B, N, N], lower triangle read
  const float* g;  // [B, N]
  float* A;        // [B, N, N] scratch: L, with L_kk⁻¹ in the diagonal blocks
  float* x;        // [B, N]
  int* info;       // [B]
  float* w;        // [B, N]: g, then y
  float* Pt;       // [NB][Wp]: the current panel, transposed
  float* Yc;       // [NB][NB]: the current diagonal block's inverse
  int N;
  int Wp;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// (ti, tl), tl ≤ ti, of the t-th tile of a lower triangle counted row by row.
__device__ __forceinline__ void lower_tile(int t, int* ti, int* tl) {
  int i = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *ti = i;
  *tl = t - i * (i + 1) / 2;
}

// The verdict of system b as one value for the whole CTA.
__device__ __forceinline__ int read_verdict(const int* info, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) *flag = __ldcg(info);
  __syncthreads();
  return *flag;
}

// Two 32×32 blocks in shared memory, rows 16-byte aligned, row strides ≡ 4
// mod 32 (float4 reads of 8 lanes then fall on distinct banks). The thread
// (warp, lane) owns entries (warp + 8q, lane), q = 0..3.
// acc += P·Qᵀ
__device__ __forceinline__ void mm_nt(float* acc, const float* P, int ldp,
                                      const float* Q, int ldq, int warp,
                                      int lane) {
#pragma unroll
  for (int k4 = 0; k4 < TB / 4; ++k4) {
    const float4 q = ld4(Q + lane * ldq, k4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 p = ld4(P + (warp + GW * i) * ldp, k4);
      acc[i] = fmaf(p.x, q.x, fmaf(p.y, q.y, fmaf(p.z, q.z, fmaf(p.w, q.w,
                                                                 acc[i]))));
    }
  }
}

// acc += P·Q
__device__ __forceinline__ void mm_nn(float* acc, const float* P, int ldp,
                                      const float* Q, int ldq, int warp,
                                      int lane) {
#pragma unroll
  for (int k4 = 0; k4 < TB / 4; ++k4) {
    const float* q = Q + 4 * k4 * ldq + lane;
    const float q0 = q[0], q1 = q[ldq], q2 = q[2 * ldq], q3 = q[3 * ldq];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 p = ld4(P + (warp + GW * i) * ldp, k4);
      acc[i] = fmaf(p.x, q0, fmaf(p.y, q1, fmaf(p.z, q2, fmaf(p.w, q3,
                                                               acc[i]))));
    }
  }
}

// ---------------------------------------------------------------- factor
// The CTA factors the 32×32 tile T0 (row stride ld0, lower triangle read)
// and carries L⁻¹ along, PC = 4 columns a step and one barrier a step;
// thread (i, l) takes the cells (i, l + 8q) of the copy T and of W, the rows
// of the inverse still forming. In the step of columns j.. every thread
// factors the 4×4 pivot block itself and forms row i of L there; then a cell
// right of the columns takes T[i][l] −= Σ_c L[i][j+c]·L[l][j+c], a cell left
// of them W[i][l] −= Σ_c L[i][j+c]·X[j+c][l], where L[l][j+c] and X[j+c][l]
// come out of the same substitution from column j.. of T or rows j.. of W;
// rows j.. of X are written. Every load of a step is issued before the first
// is used. A loop of small steps: factor_invert_tile's 32 unrolled columns
// in one warp are faster alone, but this larger kernel would fetch their
// straight-line code anew at every call. Writes X = L⁻¹ (zero above the
// diagonal); returns 0 or the 1-based column of the first bad pivot, the
// same in every thread.
constexpr int PC = 4;

__device__ int factor_invert_tile_cta(const float* T0, int ld0,
                                      float (*T)[LD], float (*W)[LD],
                                      float (*X)[LD]) {
  const int i = threadIdx.x / 8, l0 = threadIdx.x % 8;
#pragma unroll
  for (int q = 0; q < TB / 8; ++q) {
    const int l = l0 + 8 * q;
    T[i][l] = (l <= i) ? T0[i * ld0 + l] : 0.f;
    W[i][l] = (i == l) ? 1.f : 0.f;
  }
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < TB; j += PC) {
    float p[PC][PC], ti[PC], src[TB / 8][PC], own[TB / 8];
#pragma unroll
    for (int r = 0; r < PC; ++r) {
#pragma unroll
      for (int c = 0; c <= r; ++c) p[r][c] = T[j + r][j + c];
      ti[r] = T[i][j + r];
    }
#pragma unroll
    for (int q = 0; q < TB / 8; ++q) {
      const int l = l0 + 8 * q;
      const bool right = l >= j + PC;
      const float* sp = right ? &T[l][j] : &W[j][l];
      const int ss = right ? 1 : LD;
#pragma unroll
      for (int c = 0; c < PC; ++c) src[q][c] = sp[c * ss];
      own[q] = right ? T[i][l] : W[i][l];
    }
    // the pivot block: L there (lp) and 1/L[c][c]
    float lp[PC][PC], inv[PC];
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      float dd = p[c][c];
#pragma unroll
      for (int m = 0; m < c; ++m) dd = fmaf(-lp[c][m], lp[c][m], dd);
      if (bad_pivot(dd)) return j + c + 1;
      inv[c] = rsqrt_refined(dd);
#pragma unroll
      for (int r = c + 1; r < PC; ++r) {
        float v = p[r][c];
#pragma unroll
        for (int m = 0; m < c; ++m) v = fmaf(-lp[r][m], lp[c][m], v);
        lp[r][c] = v * inv[c];
      }
    }
    float li[PC];  // L[i][j + c]
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      float v = ti[c];
#pragma unroll
      for (int m = 0; m < c; ++m) v = fmaf(-li[m], lp[c][m], v);
      li[c] = v * inv[c];
    }
#pragma unroll
    for (int q = 0; q < TB / 8; ++q) {
      const int l = l0 + 8 * q;
      float u[PC];  // right: L[l][j + c]; left: X[j + c][l]
      float upd = own[q];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        float v = src[q][c];
#pragma unroll
        for (int m = 0; m < c; ++m) v = fmaf(-lp[c][m], u[m], v);
        u[c] = v * inv[c];
        upd = fmaf(-li[c], u[c], upd);
      }
      if (l >= j + PC) {
        if (l <= i) T[i][l] = upd;
        if (i >= j && i < j + PC) X[i][l] = 0.f;
      } else {
        if (i >= j + PC) W[i][l] = upd;
#pragma unroll
        for (int c = 0; c < PC; ++c)
          if (i == j + c) X[i][l] = u[c];
      }
    }
    __syncthreads();
  }
  return 0;
}

// One CTA factors the NB×NB diagonal block at (d0, d0) of `src` (row stride
// N, lower triangle read) and inverts it; y_d = L_dd⁻¹ g_d with g_d from
// `gsrc`. With `Pt`, the block first takes its share of the current panel's
// update, D −= P_d·P_dᵀ, the panel's rows d0.. read from Pt (the look-ahead).
// Publishes L_dd⁻¹ over the block's lower triangle in A and whole in Yc, y_d
// in w, or, on a bad pivot, its 1-based index in info — unless `prior`, the
// system's verdict before this block, is already a bad pivot: then the
// block's inputs were never solved and nothing is published.
__device__ void factor_block(const float* src, const float* gsrc,
                             const float* Pt, int Wp, float* A, float* w,
                             float* Yc, int* info, int N, int d0, int prior,
                             float* sm, int* flag) {
  constexpr int NS = NB / TB, LDD = NB + 4, R = NB / 16;
  float* Ds = sm;             // [NB][LDD]: the block, then L
  float* Ys = Ds + NB * LDD;  // [NB][LDD]: L⁻¹
  float(*T)[LD] = reinterpret_cast<float(*)[LD]>(Ys + NB * LDD);
  float(*X)[LD] = T + TB;
  float(*W)[LD] = X + TB;
  float* gs = reinterpret_cast<float*>(W + TB);  // [NB]
  float* ys = gs + NB;                           // [NB]
  float* Ps = ys + NB;  // [NB][NB]: P_dᵀ; then the Z blocks of the inverse
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const int kb = min(NB, N - d0);

  if (Pt != nullptr) {
#pragma unroll 4
    for (int e = tid; e < NB * NB / 4; e += GT) {
      const int k = e / (NB / 4), q = e % (NB / 4);
      cp_async16(&Ps[k * NB + 4 * q], Pt + (size_t)k * Wp + d0 + 4 * q);
    }
    cp_async_commit();
  }
  // this thread's R×R entries: rows (i/4)·64 + 4·ty + i%4, columns likewise
  // with tx; every load issued before the first is used
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = (i / 4) * 64 + 4 * ty + i % 4;
      const int c = (j / 4) * 64 + 4 * tx + j % 4;
      acc[i][j] = (r < kb && c <= r)
                      ? __ldcg(&src[(size_t)(d0 + r) * N + d0 + c]) : 0.f;
    }
  if (tid < NB) gs[tid] = (tid < kb) ? __ldcg(&gsrc[d0 + tid]) : 0.f;
  if (tid == 0) *flag = 0;
  if (Pt != nullptr) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < NB; ++k) {
      float pr[R], pc[R];
#pragma unroll
      for (int h = 0; h < R / 4; ++h) {
        const float4 u = ld4(&Ps[k * NB + h * 64], ty);
        const float4 v = ld4(&Ps[k * NB + h * 64], tx);
        pr[4 * h] = u.x, pr[4 * h + 1] = u.y, pr[4 * h + 2] = u.z,
        pr[4 * h + 3] = u.w;
        pc[4 * h] = v.x, pc[4 * h + 1] = v.y, pc[4 * h + 2] = v.z,
        pc[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(-pr[i], pc[j], acc[i][j]);
    }
  }
  // the block, lower triangle, padded with the identity past N
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = (i / 4) * 64 + 4 * ty + i % 4;
      const int c = (j / 4) * 64 + 4 * tx + j % 4;
      Ds[r * LDD + c] = (r < kb && c < kb) ? (c <= r ? acc[i][j] : 0.f)
                                           : (r == c ? 1.f : 0.f);
    }
  __syncthreads();

#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int s0 = s * TB;
    // 1. the 32×32 tile (s, s), factored and inverted
    const int bad = factor_invert_tile_cta(&Ds[s0 * LDD + s0], LDD, T, W, X);
    if (bad != 0) {
      if (tid == 0) *flag = d0 + s0 + bad;
      break;
    }
#pragma unroll
    for (int q = 0; q < TB / GW; ++q) {
      const int i = warp + GW * q;
      Ys[(s0 + i) * LDD + s0 + lane] = X[i][lane];
    }
    // 2. the tiles below it, L_ts = D_ts·X_ssᵀ, by way of the free Ys(t, s)
    for (int t = s + 1; t < NS; ++t) {
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
      mm_nt(c4, &Ds[t * TB * LDD + s0], LDD, &X[0][0], LD, warp, lane);
#pragma unroll
      for (int q = 0; q < TB / GW; ++q)
        Ys[(t * TB + warp + GW * q) * LDD + s0 + lane] = c4[q];
    }
    __syncthreads();
    for (int t = s + 1; t < NS; ++t)
#pragma unroll
      for (int q = 0; q < TB / GW; ++q) {
        const int e = (t * TB + warp + GW * q) * LDD + s0 + lane;
        Ds[e] = Ys[e];
      }
    __syncthreads();
    // 3. the rest of the block: D_tu −= L_ts·L_usᵀ, s < u ≤ t (reads column
    //    block s only, writes the others)
    for (int t = s + 1; t < NS; ++t)
      for (int u = s + 1; u <= t; ++u) {
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        mm_nt(c4, &Ds[t * TB * LDD + s0], LDD, &Ds[u * TB * LDD + s0], LDD,
              warp, lane);
#pragma unroll
        for (int q = 0; q < TB / GW; ++q)
          Ds[(t * TB + warp + GW * q) * LDD + u * TB + lane] -= c4[q];
      }
    __syncthreads();
  }
  __syncthreads();
  const int bad = *flag;
  if (bad != 0 || prior != 0) {
    if (tid == 0 && prior == 0) *info = bad;
    return;
  }

  // L_dd⁻¹ off the diagonal tiles, by distance d from the diagonal:
  // Z_ts = Σ_{u=s}^{t−1} L_tu·Y_us (into Ps), then Y_ts = −X_tt·Z_ts
  float* Zs = Ps;  // [NS − 1][TB][LD]
  for (int d = 1; d < NS; ++d) {
    for (int s = 0; s + d < NS; ++s) {
      const int t = s + d;
      float z[4] = {0.f, 0.f, 0.f, 0.f};
      for (int u = s; u < t; ++u)
        mm_nn(z, &Ds[t * TB * LDD + u * TB], LDD, &Ys[u * TB * LDD + s * TB],
              LDD, warp, lane);
#pragma unroll
      for (int q = 0; q < TB / GW; ++q)
        Zs[(s * TB + warp + GW * q) * LD + lane] = z[q];
    }
    __syncthreads();
    for (int s = 0; s + d < NS; ++s) {
      const int t = s + d;
      float y4[4] = {0.f, 0.f, 0.f, 0.f};
      mm_nn(y4, &Ys[t * TB * LDD + t * TB], LDD, &Zs[s * TB * LD], LD, warp,
            lane);
#pragma unroll
      for (int q = 0; q < TB / GW; ++q)
        Ys[(t * TB + warp + GW * q) * LDD + s * TB + lane] = -y4[q];
    }
    __syncthreads();
  }
  if (tid < NB) {  // y = L⁻¹ g; what lies right of the diagonal is zero
    float v = 0.f;
    for (int g4 = 0; g4 <= tid / 4; ++g4) {
      const float4 l = ld4(&Ys[tid * LDD], g4), u = ld4(gs, g4);
      v = fmaf(l.x, u.x, fmaf(l.y, u.y, fmaf(l.z, u.z, fmaf(l.w, u.w, v))));
    }
    ys[tid] = v;
  }
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < NB * NB; e += GT) {
    const int i = e / NB, j = e % NB;
    const float v = (j <= i) ? Ys[i * LDD + j] : 0.f;
    Yc[e] = v;
    if (i < kb && j <= i) A[(size_t)(d0 + i) * N + d0 + j] = v;
  }
  if (tid < kb) w[d0 + tid] = ys[tid];
}

// ---------------------------------------------------------------- phases
__device__ void init_phase(const Args& a, int b, float* sm, int* flag) {
  const int N = a.N;
  const size_t NN = (size_t)N * N;
  const float* H = a.H + b * NN;
  const float* g = a.g + (size_t)b * N;
  float* A = a.A + b * NN;
  float* w = a.w + (size_t)b * N;
  const int kb0 = min(NB, N);
  const int G = gridDim.x;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) a.info[b] = 0;
    factor_block(H, g, nullptr, 0, A, w, a.Yc, a.info + b, N, 0, 0, sm,
                     flag);
    if (G > 1) return;
  }
  // rows kb0.. of H's lower triangle into the scratch copy, dealt to warps
  const int workers = (G > 1) ? G - 1 : 1;
  const int widx = (G > 1) ? (int)blockIdx.x - 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = (N % 4 == 0) &&
                   (reinterpret_cast<size_t>(a.H) % 16 == 0) &&
                   (reinterpret_cast<size_t>(a.A) % 16 == 0);
  for (int i = kb0 + widx * GW + warp; i < N; i += workers * GW) {
    const float* src = H + (size_t)i * N;
    float* dst = A + (size_t)i * N;
    if (vec) {  // whole float4s up to the diagonal: what lands above it is
                // never read
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      const int n4 = i / 4 + 1;
      int j = lane;
      for (; j + 96 < n4; j += 128) {
        const float4 v0 = __ldg(s4 + j), v1 = __ldg(s4 + j + 32),
                     v2 = __ldg(s4 + j + 64), v3 = __ldg(s4 + j + 96);
        d4[j] = v0, d4[j + 32] = v1, d4[j + 64] = v2, d4[j + 96] = v3;
      }
      for (; j < n4; j += 32) d4[j] = __ldg(s4 + j);
    } else {
      for (int j = lane; j <= i; j += 32) dst[j] = __ldg(src + j);
    }
  }
  for (int e = kb0 + widx * GT + (int)threadIdx.x; e < N; e += workers * GT)
    w[e] = __ldg(g + e);
}

__device__ void panel_phase(const Args& a, int b, int k, float* sm) {
  constexpr int CPT = NB / 32, LDY = NB + 4, PER = RB * NB / GT;
  const int N = a.N;
  float* A = a.A + (size_t)b * N * N;
  float* w = a.w + (size_t)b * N;
  const int k0 = k * NB, r0 = k0 + NB;
  const int nrb = (N - r0 + RB - 1) / RB;
  if ((int)blockIdx.x >= nrb) return;
  float* Ysm = sm;              // [NB][LDY]: L_kk⁻¹
  float* As = sm + NB * LDY;    // [RB][LDY]: a row block of the panel
  float* yk = As + RB * LDY;    // [NB]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll 4
  for (int e = tid; e < NB * NB / 4; e += GT) {
    const int r = e / (NB / 4), q = e % (NB / 4);
    cp_async16(&Ysm[r * LDY + 4 * q], a.Yc + r * NB + 4 * q);
  }
  cp_async_commit();
  if (tid < NB) yk[tid] = __ldcg(&w[k0 + tid]);
  for (int rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    const int R = r0 + rb * RB;
    float v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + GT * u, i = e / NB, j = e % NB;
      v[u] = (R + i < N) ? __ldcg(&A[(size_t)(R + i) * N + k0 + j]) : 0.f;
    }
    float wv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = R + warp * 4 + r;
      wv[r] = (lane == 0 && row < N) ? __ldcg(&w[row]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + GT * u;
      As[(e / NB) * LDY + e % NB] = v[u];
    }
    cp_async_wait<0>();
    __syncthreads();
    // warp: rows 4·warp.., lane: columns lane + 32c; L = A·Yᵀ
    float acc[4][CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k4 = 0; k4 < NB / 4; ++k4) {
      float4 av[4], yv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = ld4(&As[(warp * 4 + r) * LDY], k4);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        yv[c] = ld4(&Ysm[(lane + 32 * c) * LDY], k4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[r][c] = fmaf(av[r].x, yv[c].x,
                           fmaf(av[r].y, yv[c].y,
                                fmaf(av[r].z, yv[c].z,
                                     fmaf(av[r].w, yv[c].w, acc[r][c]))));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = R + warp * 4 + r;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        part = fmaf(acc[r][c], yk[lane + 32 * c], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
      if (row < N) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          A[(size_t)row * N + k0 + lane + 32 * c] = acc[r][c];
        if (lane == 0) w[row] = wv[r] - part;
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      *reinterpret_cast<float4*>(
          &a.Pt[(size_t)(lane + 32 * c) * a.Wp + R + warp * 4]) =
          make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    __syncthreads();  // As free
  }
}

// The trailing update's tiles t_first, t_first + t_step, … < T of step k,
// all but the diagonal block at r0 (CTA 0's).
__device__ void update_tiles(const Args& a, float* A, int r0, int T,
                             int t_first, int t_step, float* sm) {
  constexpr int NK = NB / KC;
  const int N = a.N;
  if (t_first >= T) return;
  const int n_items = ((T - 1 - t_first) / t_step + 1) * NK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool vec = (N % 4 == 0) && (reinterpret_cast<size_t>(a.A) % 16 == 0);
  const int dend = r0 + NB;  // rows and columns < dend: the diagonal block

  auto issue = [&](int item, int buf) {
    int ti, tl;
    lower_tile(t_first + (item / NK) * t_step, &ti, &tl);
    const int kc = item % NK;
    const int I0 = r0 + ti * UT2, J0 = r0 + tl * UT2;
    float* As = sm + buf * 2 * KC * UT2;
    float* Bs = As + KC * UT2;
#pragma unroll
    for (int it = 0; it < KC * UT2 / 4 / GT; ++it) {
      const int e = tid + GT * it;
      const int kk = e / (UT2 / 4), q = e % (UT2 / 4);
      const float* row = a.Pt + (size_t)(kc * KC + kk) * a.Wp;
      cp_async16(&As[kk * UT2 + 4 * q], row + I0 + 4 * q);
      cp_async16(&Bs[kk * UT2 + 4 * q], row + J0 + 4 * q);
    }
    cp_async_commit();
  };
  // entry (i, h) of this thread's part of the tile at (I0, J0): row
  // I0 + (i/4)·64 + 4·ty + i%4, columns J0 + 64h + 4tx .. + 3
  auto seg = [&](int I0, int J0, int i, int h, int* row, int* c0) {
    *row = I0 + (i / 4) * 64 + 4 * ty + i % 4;
    *c0 = J0 + 64 * h + 4 * tx;
    return *row < N && *c0 < N && *c0 <= *row && !(*row < dend && *c0 < dend);
  };

  float acc[8][8], old[8][8];
  issue(0, 0);
  for (int item = 0; item < n_items; ++item) {
    const int cur = item & 1;
    if (item + 1 < n_items) {
      issue(item + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (item % NK == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const bool last = item % NK == NK - 1;
    int I0 = 0, J0 = 0;
    if (last) {  // fetch what the tile holds now, under the last chunk
      int ti, tl;
      lower_tile(t_first + (item / NK) * t_step, &ti, &tl);
      I0 = r0 + ti * UT2, J0 = r0 + tl * UT2;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int row, c0;
          const bool on = seg(I0, J0, i, h, &row, &c0);
          const float* p = A + (size_t)row * N + c0;
          if (vec) {
            const float4 o = on ? __ldcg(reinterpret_cast<const float4*>(p))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            old[i][4 * h] = o.x, old[i][4 * h + 1] = o.y,
            old[i][4 * h + 2] = o.z, old[i][4 * h + 3] = o.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              old[i][4 * h + c] = (on && c0 + c < N) ? __ldcg(p + c) : 0.f;
          }
        }
    }
    const float* As = sm + cur * 2 * KC * UT2;
    const float* Bs = As + KC * UT2;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = ld4(&As[kk * UT2], ty);
      const float4 a1 = ld4(&As[kk * UT2 + 64], ty);
      const float4 b0 = ld4(&Bs[kk * UT2], tx);
      const float4 b1 = ld4(&Bs[kk * UT2 + 64], tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (last) {  // A −= acc on the tile's lower part
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int row, c0;
          if (!seg(I0, J0, i, h, &row, &c0)) continue;
          float* p = A + (size_t)row * N + c0;
          if (vec) {
            *reinterpret_cast<float4*>(p) = make_float4(
                old[i][4 * h] - acc[i][4 * h],
                old[i][4 * h + 1] - acc[i][4 * h + 1],
                old[i][4 * h + 2] - acc[i][4 * h + 2],
                old[i][4 * h + 3] - acc[i][4 * h + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c0 + c < N) p[c] = old[i][4 * h + c] - acc[i][4 * h + c];
          }
        }
    }
    __syncthreads();  // buffer cur is refilled next
  }
}

__device__ void update_phase(const Args& a, int b, int k, float* sm,
                             int* flag) {
  const int N = a.N;
  float* A = a.A + (size_t)b * N * N;
  float* w = a.w + (size_t)b * N;
  const int r0 = (k + 1) * NB;
  const int nt = (N - r0 + UT2 - 1) / UT2;
  const int T = nt * (nt + 1) / 2;
  const int G = gridDim.x;
  // a tile that is all diagonal block is CTA 0's alone
  const int t0 = (NB >= UT2) ? 1 : 0;
  if (blockIdx.x == 0) {
    // look-ahead: the next diagonal block takes its update from the panel
    // and is factored while the others update the rest. Only CTA 0 writes
    // info, so it reads its own verdict; after a bad pivot the others'
    // work is on values that the NaN of x discards.
    const int prior = __ldcg(a.info + b);
    factor_block(A, w, a.Pt, a.Wp, A, w, a.Yc, a.info + b, N, r0, prior,
                     sm, flag);
    if (G == 1) {
      __syncthreads();
      update_tiles(a, A, r0, T, t0, 1, sm);
    }
  } else {
    update_tiles(a, A, r0, T, t0 + (int)blockIdx.x - 1, G - 1, sm);
  }
}

__device__ void backward_phase(const Args& a, int b, int m, int nblk,
                               float* sm, int* flag) {
  constexpr int LDY = NB + 1, PER = NB * NB / GT, RPW = NB / GW;
  const int N = a.N;
  const float* A = a.A + (size_t)b * N * N;
  float* w = a.w + (size_t)b * N;
  float* x = a.x + (size_t)b * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = gridDim.x;
  if (read_verdict(a.info + b, flag) != 0) {
    if (m == nblk - 1)
      for (int e = blockIdx.x * GT + tid; e < N; e += G * GT) x[e] = nanf("");
    return;
  }
  const int m0 = m * NB, kbm = min(NB, N - m0);
  const int nch = (m0 + 31) / 32;
  if (blockIdx.x != 0 && (int)blockIdx.x >= nch) return;
  float* Ys = sm;               // [NB][LDY]: L_mm⁻¹
  float* ys = Ys + NB * LDY;    // [NB]
  float* xm = ys + NB;          // [NB]
  float* red = xm + NB;         // [GW][32]
  // every load of the step issued before the first is used: the block's
  // inverse, y_m, and the rows of the first column chunk
  float v[PER], lv[RPW];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + GT * u, i = e / NB, j = e % NB;
    v[u] = (i < kbm && j <= i) ? __ldcg(&A[(size_t)(m0 + i) * N + m0 + j])
                               : 0.f;
  }
  const float yv = (tid < kbm) ? __ldcg(&w[m0 + tid]) : 0.f;
  int ch = blockIdx.x;
  auto fetch = [&](int c) {
    const int col = c * 32 + lane;
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const int r = warp + GW * u;
      lv[u] = (col < m0 && r < kbm)
                  ? __ldcg(&A[(size_t)(m0 + r) * N + col]) : 0.f;
    }
  };
  if (ch < nch) fetch(ch);
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + GT * u;
    Ys[(e / NB) * LDY + e % NB] = v[u];
  }
  if (tid < NB) ys[tid] = yv;
  __syncthreads();
  if (tid < NB) {  // x_m = L_mm⁻ᵀ y_m; zero past the block
    float s = 0.f;
    for (int r = tid; r < kbm; ++r) s = fmaf(Ys[r * LDY + tid], ys[r], s);
    xm[tid] = s;
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid < kbm) x[m0 + tid] = xm[tid];
  // y_j −= L_mjᵀ x_m over the columns before the block, 32 at a time
  for (; ch < nch; ch += G) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < RPW; ++u) s = fmaf(lv[u], xm[warp + GW * u], s);
    red[warp * 32 + lane] = s;
    __syncthreads();
    const int col = ch * 32 + lane;
    if (warp == 0 && col < m0) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < GW; ++q) t += red[q * 32 + lane];
      w[col] = __ldcg(&w[col]) - t;
    }
    if (ch + G < nch) fetch(ch + G);
    __syncthreads();
  }
}

// One system is 3·nblk − 1 phases: init; panel and update for each block
// but the last; back for each block from the last. One cooperative launch
// runs every phase of every system in turn, a grid barrier between two.
__global__ void __launch_bounds__(GT, 1) chol_solve_grid_kernel(Args a,
                                                                int B) {
  extern __shared__ __align__(16) float smem[];
  int* flag = reinterpret_cast<int*>(smem);
  float* sm = smem + HDR;
  const int nblk = (a.N + NB - 1) / NB;
  const int P = 3 * nblk - 1;
  for (int p = 0; p < B * P; ++p) {
    const int b = p / P, q = p % P;
    if (q == 0) {
      init_phase(a, b, sm, flag);
    } else if (q <= 2 * (nblk - 1)) {
      const int k = (q - 1) / 2;
      if ((q - 1) % 2 == 0)
        panel_phase(a, b, k, sm);
      else
        update_phase(a, b, k, sm, flag);
    } else {
      backward_phase(a, b, nblk - 1 - (q - 1 - 2 * (nblk - 1)), nblk, sm,
                     flag);
    }
    if (p + 1 < B * P) cg::this_grid().sync();
  }
}

constexpr int smem_floats() {
  constexpr int factor = 2 * NB * (NB + 4) + 3 * TB * LD + 2 * NB + NB * NB;
  constexpr int panel = (NB + RB) * (NB + 4) + NB;
  constexpr int update = 4 * KC * UT2;
  constexpr int back = NB * (NB + 1) + 2 * NB + GW * 32;
  constexpr int m1 = factor > panel ? factor : panel;
  constexpr int m2 = update > back ? update : back;
  return HDR + (m1 > m2 ? m1 : m2);
}
constexpr int SMEM_BYTES = smem_floats() * (int)sizeof(float);

// Floats of the work buffer: w [B·N], Pt [NB][Wp], Yc [NB][NB], each
// starting on 256 bytes.
long long work_layout(int B, int N, long long* pt_off, long long* yc_off,
                      int* Wp) {
  *Wp = round_up(N, 4) + UT2;
  *pt_off = ((long long)B * N + 63) / 64 * 64;
  *yc_off = *pt_off + ((long long)NB * *Wp + 63) / 64 * 64;
  return *yc_off + (long long)NB * NB;
}

}  // namespace

// Floats the work buffer of a grid launch needs (see work_layout).
extern "C" long long bst_cholesky_grid_work_floats(int B, int N) {
  long long pt_off, yc_off;
  int Wp;
  return work_layout(B, N, &pt_off, &yc_off, &Wp);
}

// CTAs of the cooperative grid launch on the current device: one per SM, or
// 0 where the device has no cooperative launch or cannot hold the kernel's
// CTA on an SM. Also sets the kernel's dynamic shared memory limit there.
// A failing CUDA call gives −(its cudaError_t).
extern "C" int bst_cholesky_grid_ctas() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && coop)
    err = cudaFuncSetAttribute(chol_solve_grid_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err == cudaSuccess && coop)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chol_solve_grid_kernel, GT, SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return (coop && per_sm >= 1) ? sms : 0;
}

// H [B,N,N] (lower triangle read), g [B,N] inputs (read only); scratch
// [B,N,N] receives L with L_kk⁻¹ in its diagonal blocks; x [B,N]; info [B]
// int32; work: bst_cholesky_grid_work_floats(B, N) floats, 16-byte aligned.
// ctas: the grid, a positive value of bst_cholesky_grid_ctas on this device
// (which also raises the kernel's shared memory limit). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bst_cholesky_grid_solve_f32(const float* H, const float* g,
                                           float* scratch, float* x,
                                           int* info, float* work, int B,
                                           int N, int ctas, void* stream) {
  if (B < 1 || N < 1 || ctas < 1 ||
      reinterpret_cast<size_t>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  long long pt_off, yc_off;
  int Wp;
  work_layout(B, N, &pt_off, &yc_off, &Wp);
  Args a{H, g, scratch, x, info, work, work + pt_off, work + yc_off, N, Wp};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(GT, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chol_solve_grid_kernel, a,
                                             B);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
