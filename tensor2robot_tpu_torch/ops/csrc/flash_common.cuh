// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the masking cap, the tile sizes, dtype conversion, floor division and
// the visibility tests.
// Each library is built with -DT2R_HEAD_DIM=16|32|64|128 (the wrappers pad
// any other head dim up to 128 to the next of them with zero columns).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef T2R_HEAD_DIM
#error "compile with -DT2R_HEAD_DIM=16, 32, 64 or 128"
#endif
// Every size is a whole number of m16n8k8 k-steps (D / 8: two at D = 16)
// and of 16-byte cp.async chunks (D / 4), and rows padded to D + 4 words
// stay on 16 bytes.
static_assert(T2R_HEAD_DIM == 16 || T2R_HEAD_DIM == 32 || T2R_HEAD_DIM == 64 ||
                  T2R_HEAD_DIM == 128,
              "T2R_HEAD_DIM must be 16, 32, 64 or 128");

namespace t2r {

// The finite cap of a masked logit (the JAX package's _NEG_INF).
constexpr float kNegInf = -1e30f;
// Rows (or keys) owned by one thread block of 4 warps, 16 per warp.
constexpr int kBlockRows = 64;

// Length of a staged tile: the forward's and dq's k-tile, dkv's q-tile
// (ops/flash_attention.py: block_k_for): the plain versions walk the same
// tiles, so a kernel and its plain version skip the same ones.
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

// Whether any pair of the rows at positions [r_lo, r_hi] and the keys at
// [c_lo, c_hi] is visible (a tile test; visible() decides each pair).
__device__ __forceinline__ bool any_visible(int r_lo, int r_hi, int c_lo,
                                            int c_hi, int causal, int window) {
  if (causal && r_hi < c_lo) return false;
  if (window > 0 && r_lo - c_hi >= window) return false;
  return true;
}

// Whether every such pair is visible (then no pair needs its own test).
__device__ __forceinline__ bool all_visible(int r_lo, int r_hi, int c_lo,
                                            int c_hi, int causal, int window) {
  if (causal && r_lo < c_hi) return false;
  if (window > 0 && r_hi - c_lo >= window) return false;
  return true;
}

}  // namespace t2r
