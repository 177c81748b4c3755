// Flash-attention forward (normalized output) for Hopper, sm_90a.
//
// Replaces `_flash_kernel` of tensor2robot_tpu/ops/flash_attention.py
// (body `_flash_body`, launched by `_flash_attention_fwd_impl` through
// pl.pallas_call): o = softmax(q k^T * scale) v over [B, S, H, D], causal
// and causal-sliding-window masks in GLOBAL positions (q_offset, k_offset),
// online softmax in f32 with the finite cap -1e30, a fully masked tile
// contributes exactly 0, the row sum is floored at 1e-30 (a row that sees
// no key comes out 0), and the result is cast to the input dtype.
//
// What bounds it on an H100. At the transformer-BC serving shape
// (B=8, S=1024, H=8, D=32, causal, f32) the work is ~4.3 GFLOP of f32 FMA
// against 33.5 MB of q/k/v/o: 64 us at the 67 TFLOP/s f32 peak versus
// 10 us at 3.35 TB/s, so the kernel is bound by operations. f32 inputs are
// computed in full f32 FMA (no TF32: the JAX package asks for
// Precision.HIGHEST on f32, so TF32 would miss its 2e-5 tolerance); bf16
// inputs are widened to f32 on load, as the Pallas body does.
//
// Design, simple and right first:
//   * one thread block per (q-tile of 64 rows, head, batch); one thread
//     per query row, holding its pre-scaled q row and its running
//     (o, l, m) in f32 registers;
//   * the block loops over ONLY the visible k-tiles, with the exact
//     bounds of `_k_block_bounds` (causal upper bound from the tile's last
//     real row, window lower bound from its first), and masks per element;
//   * each k/v tile is staged once in shared memory (widened to f32) and
//     read by every thread of the block at the same address (broadcast);
//   * q/k/v/o are addressed by their strides in [B, S, H, D] (last dim
//     contiguous), so the caller's views of a fused qkv projection are read
//     in place: no [B*H, S, D] transpose-fold;
//   * ragged tails (S not a multiple of the tile) are masked in the kernel,
//     so any length runs here (no block-divisor fallback).
// wgmma/TMA tiles are later work; this kernel is the correctness baseline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// One library per head dim, built with -DT2R_HEAD_DIM=32|64|128, so a
// caller builds only the head dim it runs and the builds run in parallel.
#ifndef T2R_HEAD_DIM
#error "compile with -DT2R_HEAD_DIM=32, 64 or 128"
#endif
static_assert(T2R_HEAD_DIM == 32 || T2R_HEAD_DIM == 64 || T2R_HEAD_DIM == 128,
              "T2R_HEAD_DIM must be 32, 64 or 128");

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kChunk = 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, sk;
  float scale;
  int causal, window, q_offset, k_offset;
};

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

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kBlockQ) flash_fwd_kernel(const Params p) {
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];

  const int q_block = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = q_block * kBlockQ + tid;
  const bool row_valid = row < p.sq;

  const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[D];
  float acc[D];
  if (row_valid) {
    const T* q_row = static_cast<const T*>(p.q) + b * p.q_sb +
                     static_cast<long long>(row) * p.q_ss + h * p.q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = to_float(q_row[d]) * p.scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // Visible k-tiles: exact per tile, as _k_block_bounds, with the causal
  // bound taken from the tile's last REAL row (ragged tail).
  const int rows = min(kBlockQ, p.sq - q_block * kBlockQ);
  const int q0 = p.q_offset + q_block * kBlockQ;
  const int q_pos = p.q_offset + row;
  const int num_kb = (p.sk + BK - 1) / BK;
  int j_lo = 0;
  int j_hi = num_kb;
  if (p.causal) {
    j_hi = max(0, min(num_kb, floor_div(q0 + rows - 1 - p.k_offset, BK) + 1));
  }
  if (p.window > 0) {
    j_lo = max(0, floor_div(q0 - p.window + 1 - p.k_offset, BK));
  }

  for (int j = j_lo; j < j_hi; ++j) {
    const int key0 = j * BK;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D; idx += kBlockQ) {
      const int c = idx / D;
      const int d = idx - c * D;
      const int key = key0 + c;
      float kv = 0.f;
      float vv = 0.f;
      if (key < p.sk) {
        kv = to_float(k_base[static_cast<long long>(key) * p.k_ss + d]);
        vv = to_float(v_base[static_cast<long long>(key) * p.v_ss + d]);
      }
      k_tile[idx] = kv;
      v_tile[idx] = vv;
    }
    __syncthreads();

    // The staged tile is consumed in chunks of kChunk keys, each an
    // online-softmax step: the unrolled body stays small (registers,
    // compile time) and the result differs from one step per tile only
    // by rounding.
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += kChunk) {
      float s[kChunk];
      float m_blk = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* k_row = k_tile + (c0 + c) * D;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], k_row[d], dot);
        const int key = key0 + c0 + c;
        const int k_pos = p.k_offset + key;
        bool visible = key < p.sk;
        if (p.causal) visible = visible && (q_pos >= k_pos);
        if (p.window > 0) visible = visible && (q_pos - k_pos < p.window);
        s[c] = visible ? dot : kNegInf;
        m_blk = fmaxf(m_blk, s[c]);
      }
      const float m_new = fmaxf(m, m_blk);
      const float alpha = expf(m - m_new);
      // A row that has seen no visible key keeps m at the cap: masked keys
      // contribute nothing (not exp(0) = 1 each).
      const bool dead = (m_new == kNegInf);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float pc = dead ? 0.f : expf(s[c] - m_new);
        s[c] = pc;
        row_sum += pc;
      }
      l = l * alpha + row_sum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* v_row = v_tile + (c0 + c) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(s[c], v_row[d], acc[d]);
      }
      m = m_new;
    }
  }

  if (row_valid) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* o_row = static_cast<T*>(p.o) + b * p.o_sb +
               static_cast<long long>(row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) o_row[d] = from_float<T>(acc[d] / l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int BK = D <= 64 ? 64 : 32;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<T, D, BK><<<grid, kBlockQ, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16; head_dim must be this library's T2R_HEAD_DIM. Strides are
// in elements; the head dim must be contiguous. window <= 0 means no
// window. Returns the cudaError_t of the launch.
extern "C" int t2r_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int sk, int head_dim, int dtype, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    int window, int q_offset, int k_offset, void* stream) {
  const Params p{q,    k,    v,    o,    q_sb, q_ss,  q_sh,   k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,  o_ss,   o_sh,
                 sq,   sk,   scale, causal, window, q_offset, k_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != T2R_HEAD_DIM) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, T2R_HEAD_DIM>(p, batch, heads, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16, T2R_HEAD_DIM>(p, batch, heads, s);
  }
  return cudaErrorInvalidValue;
}
