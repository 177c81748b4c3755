// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the masking cap, the tile sizes, dtype conversion and floor division.
// Each library is built with -DT2R_HEAD_DIM=32|64|128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef T2R_HEAD_DIM
#error "compile with -DT2R_HEAD_DIM=32, 64 or 128"
#endif
static_assert(T2R_HEAD_DIM == 32 || T2R_HEAD_DIM == 64 || T2R_HEAD_DIM == 128,
              "T2R_HEAD_DIM must be 32, 64 or 128");

namespace t2r {

// The finite cap of a masked logit (the JAX package's _NEG_INF).
constexpr float kNegInf = -1e30f;
// Rows (or keys) owned by one thread block: one thread each in the
// forward, 16 per warp in the backward.
constexpr int kBlockRows = 64;

// Length of a staged tile: the forward's and dq's k-tile, dkv's q-tile
// (ops/flash_attention.py: block_k_for). Bounded by the registers that a
// thread's rows take at the head dim.
template <int D>
constexpr int staged_tile() {
  return D <= 64 ? 64 : 32;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Python's floor division for b > 0 (C++ '/' truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Whether query position q_pos may attend to key position k_pos; `key` and
// `row` are the in-range checks of ragged tails.
__device__ __forceinline__ bool visible(bool in_range, int q_pos, int k_pos,
                                        int causal, int window) {
  bool ok = in_range;
  if (causal) ok = ok && (q_pos >= k_pos);
  if (window > 0) ok = ok && (q_pos - k_pos < window);
  return ok;
}

}  // namespace t2r
