// What K1's two schedules share (cholesky.cu: a thread-block cluster per
// system; cholesky_grid.cu: the whole card on one system): the 32-wide
// diagonal tile and the pivot's arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TB = 32;       // panel width = diagonal tile
constexpr int LD = TB + 4;   // padded shared row stride: rows stay 16-byte
                             // aligned, and neither a column of scalars nor a
                             // column of float4 collides on a bank
constexpr unsigned FULL = 0xffffffffu;

// Four consecutive floats of a shared-memory row, as one 128-bit read.
__device__ __forceinline__ float4 ld4(const float* row, int g) {
  return reinterpret_cast<const float4*>(row)[g];
}

__device__ __forceinline__ bool bad_pivot(float d) {
  return !(d > 0.f) || !isfinite(d);
}

// 1/√d: the hardware's approximation and one Newton step.
__device__ __forceinline__ float rsqrt_refined(float d) {
  const float r = rsqrtf(d);
  return r * (1.5f - (0.5f * d * r) * r);
}

}  // namespace
