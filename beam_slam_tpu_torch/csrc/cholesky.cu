// Batched dense Cholesky factor + solve for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel beam_slam_tpu/ops/pallas_cholesky.py ::
// cholesky_solve_batched (body _chol_solve_kernel): x = H⁻¹ g for B damped,
// Jacobi-equilibrated SPD systems H [B, N, N], g [B, N], f32. On the LM path
// this is the reduced camera system of every iteration (N = 640 for the
// flagship window after the caller's 128-padding).
//
// Design: one CTA per system (grid = B, 256 threads), right-looking blocked
// Cholesky in 32-wide panels, working on a scratch copy of H in global memory
// (one 640² f32 system is 1.6 MB: far above the 227 KB of shared memory a
// block may use, and well inside the 50 MB L2, so the trailing matrix lives
// in L2 and streams through shared memory tile by tile):
//   1. factor the 32×32 diagonal tile in shared memory;
//   2. solve the panel below it (one thread per row, 256 rows at a time);
//   3. apply the symmetric rank-32 update to the trailing LOWER triangle,
//      32×32 tile by tile (the upper triangle is never read);
// then the forward and backward substitutions in the same launch.
//
// What bounds it: at B = 1 one CTA uses 1 of the card's 132 SMs, and the
// panel recurrences are serial chains separated by block barriers, so the
// kernel is latency-bound and likely slower there than the library path it
// stands beside. At B = 8 it runs 8 systems on 8 SMs at once. A multi-CTA
// trailing update (cluster / cooperative split of the tiles), and wgmma/TMA
// for the rank-32 update, are later work.
//
// A non-positive (or non-finite) pivot is NOT clamped, unlike the TPU
// kernel's 1e-20 floor: info[b] gets the 1-based index of the first bad
// pivot and x[b] is filled with NaN, which is what the XLA cholesky path
// gives the reference's single-window solve and what its step gate tests.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the scratch buffer and the stream, and checks the returned launch error.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TB = 32;       // panel / tile width
constexpr int NT = 256;      // threads per CTA
constexpr int LD = TB + 1;   // padded shared row stride (no bank conflicts)

__global__ void __launch_bounds__(NT)
chol_solve_kernel(const float* __restrict__ H, const float* __restrict__ g,
                  float* __restrict__ A_all, float* __restrict__ x_all,
                  int* __restrict__ info_all, int N) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t NN = (size_t)N * N;
  const float* Hb = H + (size_t)b * NN;
  float* A = A_all + (size_t)b * NN;
  float* x = x_all + (size_t)b * N;

  __shared__ float T[TB][LD];   // diagonal tile L_kk
  __shared__ float Pn[NT][LD];  // panel rows; two 32-row tiles in the update
  __shared__ float yb[TB];
  __shared__ int s_info;

  for (size_t e = tid; e < NN; e += NT) A[e] = Hb[e];
  for (int e = tid; e < N; e += NT) x[e] = g[(size_t)b * N + e];
  if (tid == 0) s_info = 0;

  // ---------------- factor: A ← L (lower triangle) ----------------
  for (int k0 = 0; k0 < N; k0 += TB) {
    const int kb = min(TB, N - k0);
    __syncthreads();  // previous trailing update (or the copy) is complete
    for (int e = tid; e < TB * TB; e += NT) {
      const int i = e / TB, j = e % TB;
      T[i][j] = (i < kb && j <= i) ? A[(size_t)(k0 + i) * N + k0 + j] : 0.f;
    }
    __syncthreads();

    // 1. unblocked factor of the diagonal tile
    for (int j = 0; j < kb; ++j) {
      const float d = T[j][j];  // every thread reads the same value
      if (!(d > 0.f) || !isfinite(d)) {
        if (tid == 0) s_info = k0 + j + 1;
        break;  // uniform across the block
      }
      const float ljj = sqrtf(d);
      __syncthreads();  // T[j][j] read by all before it is overwritten
      if (tid == 0) T[j][j] = ljj;
      for (int i = j + 1 + tid; i < kb; i += NT) T[i][j] /= ljj;
      __syncthreads();
      for (int e = tid; e < TB * TB; e += NT) {
        const int i = e / TB, l = e % TB;
        if (i < kb && l > j && l <= i) T[i][l] -= T[i][j] * T[l][j];
      }
      __syncthreads();
    }
    __syncthreads();
    if (s_info != 0) break;  // uniform: s_info is shared

    for (int e = tid; e < TB * TB; e += NT) {
      const int i = e / TB, j = e % TB;
      if (i < kb && j <= i) A[(size_t)(k0 + i) * N + k0 + j] = T[i][j];
    }

    // 2. panel solve: L[r, k0:k0+kb] = A[r, k0:k0+kb] · L_kk⁻ᵀ
    const int r0 = k0 + kb;
    for (int rb = r0; rb < N; rb += NT) {
      const int rn = min(NT, N - rb);
      __syncthreads();  // Pn free
      for (int e = tid; e < NT * TB; e += NT) {
        const int i = e / TB, j = e % TB;
        Pn[i][j] = (i < rn && j < kb) ? A[(size_t)(rb + i) * N + k0 + j] : 0.f;
      }
      __syncthreads();
      if (tid < rn) {
        for (int j = 0; j < kb; ++j) {
          float s = Pn[tid][j];
          for (int l = 0; l < j; ++l) s -= Pn[tid][l] * T[j][l];
          Pn[tid][j] = s / T[j][j];
        }
      }
      __syncthreads();
      for (int e = tid; e < NT * TB; e += NT) {
        const int i = e / TB, j = e % TB;
        if (i < rn && j < kb) A[(size_t)(rb + i) * N + k0 + j] = Pn[i][j];
      }
    }

    // 3. trailing update of the lower triangle: A[i, l] -= L[i, :] · L[l, :]
    float(*Li)[LD] = Pn;
    float(*Ll)[LD] = Pn + TB;
    const int nt = (N - r0 + TB - 1) / TB;
    const int ty = tid / 16, tx = tid % 16;  // 2×2 outputs per thread
    for (int ti = 0; ti < nt; ++ti) {
      for (int tl = 0; tl <= ti; ++tl) {
        const int ri = r0 + ti * TB, rl = r0 + tl * TB;
        const int ni = min(TB, N - ri), nl = min(TB, N - rl);
        __syncthreads();  // panel written; tiles free
        for (int e = tid; e < TB * TB; e += NT) {
          const int i = e / TB, j = e % TB;
          Li[i][j] = (i < ni && j < kb) ? A[(size_t)(ri + i) * N + k0 + j] : 0.f;
          Ll[i][j] = (i < nl && j < kb) ? A[(size_t)(rl + i) * N + k0 + j] : 0.f;
        }
        __syncthreads();
        float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int j = 0; j < kb; ++j) {
          const float a0 = Li[2 * ty][j], a1 = Li[2 * ty + 1][j];
          const float c0 = Ll[2 * tx][j], c1 = Ll[2 * tx + 1][j];
          acc[0][0] += a0 * c0;
          acc[0][1] += a0 * c1;
          acc[1][0] += a1 * c0;
          acc[1][1] += a1 * c1;
        }
        for (int a = 0; a < 2; ++a) {
          for (int c = 0; c < 2; ++c) {
            const int i = 2 * ty + a, l = 2 * tx + c;
            if (i < ni && l < nl && ri + i >= rl + l)
              A[(size_t)(ri + i) * N + rl + l] -= acc[a][c];
          }
        }
      }
    }
  }
  __syncthreads();

  if (s_info != 0) {
    for (int e = tid; e < N; e += NT) x[e] = nanf("");
    if (tid == 0) info_all[b] = s_info;
    return;
  }

  const int warp = tid / 32, lane = tid % 32;

  // ---------------- forward substitution: x ← L⁻¹ g ----------------
  for (int k0 = 0; k0 < N; k0 += TB) {
    const int kb = min(TB, N - k0);
    __syncthreads();  // x rows of this block are final
    for (int e = tid; e < TB * TB; e += NT) {
      const int i = e / TB, j = e % TB;
      T[i][j] = (i < kb && j <= i) ? A[(size_t)(k0 + i) * N + k0 + j] : 0.f;
    }
    if (tid < kb) yb[tid] = x[k0 + tid];
    __syncthreads();
    if (warp == 0) {
      for (int j = 0; j < kb; ++j) {
        const float yj = yb[j] / T[j][j];
        __syncwarp();
        if (lane == j) yb[j] = yj;
        if (lane > j && lane < kb) yb[lane] -= T[lane][j] * yj;
        __syncwarp();
      }
    }
    __syncthreads();
    if (tid < kb) x[k0 + tid] = yb[tid];
    for (int i = k0 + kb + warp; i < N; i += NT / 32) {
      float v = (lane < kb) ? A[(size_t)i * N + k0 + lane] * yb[lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) x[i] -= v;
    }
  }

  // ---------------- backward substitution: x ← L⁻ᵀ x ----------------
  const int nblk = (N + TB - 1) / TB;
  for (int kbi = nblk - 1; kbi >= 0; --kbi) {
    const int k0 = kbi * TB;
    const int kb = min(TB, N - k0);
    __syncthreads();
    for (int e = tid; e < TB * TB; e += NT) {
      const int i = e / TB, j = e % TB;
      T[i][j] = (i < kb && j <= i) ? A[(size_t)(k0 + i) * N + k0 + j] : 0.f;
    }
    if (tid < kb) yb[tid] = x[k0 + tid];
    __syncthreads();
    if (warp == 0) {
      for (int j = kb - 1; j >= 0; --j) {
        const float zj = yb[j] / T[j][j];
        __syncwarp();
        if (lane == j) yb[j] = zj;
        if (lane < j) yb[lane] -= T[j][lane] * zj;
        __syncwarp();
      }
    }
    __syncthreads();
    if (tid < kb) x[k0 + tid] = yb[tid];
    for (int i = tid; i < k0; i += NT) {
      float s = 0.f;
      for (int j = 0; j < kb; ++j) s += A[(size_t)(k0 + j) * N + i] * yb[j];
      x[i] -= s;
    }
  }
  if (tid == 0) info_all[b] = 0;
}

}  // namespace

// H [B,N,N], g [B,N] inputs (read only); scratch [B,N,N] receives L;
// x [B,N] the solution; info [B] int32. All device pointers, row-major,
// contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int bst_cholesky_solve_batched_f32(const float* H, const float* g,
                                              float* scratch, float* x,
                                              int* info, int B, int N,
                                              void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  chol_solve_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(H, g, scratch, x,
                                                        info, N);
  return (int)cudaGetLastError();
}
