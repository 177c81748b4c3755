// Flash-attention forward for Hopper, sm_90a: two kernels of one body.
//
// Replaces, from tensor2robot_tpu/ops/flash_attention.py:
//   * `_flash_kernel` (body `_flash_body`, launched by
//     `_flash_attention_fwd_impl` through pl.pallas_call): the NORMALIZED
//     output o = softmax(q k^T * scale) v, cast to the input dtype, with
//     the row sum floored at 1e-30 (a row that sees no key comes out 0).
//     Exported as t2r_flash_fwd; the forward used when no gradient is taken.
//   * `_flash_tile_kernel` (launched by `flash_attention_tile`): the same
//     recurrence emitting the UNNORMALIZED f32 accumulator o with the row
//     stats l (sum) and m (max) in [B, H, Sq] f32 — the training forward's
//     residuals (lse = m + log l). Exported as t2r_flash_fwd_tile.
// Both take [B, S, H, D] by strides, causal and causal-sliding-window masks
// in GLOBAL positions (q_offset, k_offset), online softmax in f32 with the
// finite cap -1e30, and a fully masked tile contributing exactly 0.
//
// What bounds them on an H100. At the transformer-BC shape (B=8, S=1024,
// H=8, D=32, causal, f32) the work is ~4.3 GFLOP of f32 FMA against
// 33.5 MB of q/k/v/o: 64 us at the 67 TFLOP/s f32 peak versus 10 us at
// 3.35 TB/s, so they are bound by operations. f32 inputs are computed in
// full f32 FMA (no TF32: the JAX package asks for Precision.HIGHEST on f32,
// so TF32 would miss its 2e-5 tolerance); bf16 inputs are widened to f32 on
// load, as the Pallas body does.
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
// wgmma/TMA tiles are later work; these kernels are the correctness baseline.

#include "flash_common.cuh"

namespace {

using namespace t2r;

constexpr int kChunk = 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;  // [B, H, Sq] row sums (tile kernel only)
  float* m;  // [B, H, Sq] row maxima (tile kernel only)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, sk;
  float scale;
  int causal, window, q_offset, k_offset;
};

// kTile = false: normalized output of type T (B2). kTile = true: the raw
// f32 accumulator and the row stats (B1).
template <typename T, int D, int BK, bool kTile>
__global__ void __launch_bounds__(kBlockRows) flash_fwd_kernel(const Params p) {
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];

  const int q_block = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = q_block * kBlockRows + tid;
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
  const int rows = min(kBlockRows, p.sq - q_block * kBlockRows);
  const int q0 = p.q_offset + q_block * kBlockRows;
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
    for (int idx = tid; idx < BK * D; idx += kBlockRows) {
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
        const bool ok = visible(key < p.sk, q_pos, p.k_offset + key,
                                p.causal, p.window);
        s[c] = ok ? dot : kNegInf;
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

  if (!row_valid) return;
  if constexpr (kTile) {
    float* o_row = static_cast<float*>(p.o) + b * p.o_sb +
                   static_cast<long long>(row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) o_row[d] = acc[d];
    const long long stat = (static_cast<long long>(b) * gridDim.y + h) * p.sq + row;
    p.l[stat] = l;
    p.m[stat] = m;
  } else {
    const float l_safe = fmaxf(l, 1e-30f);
    T* o_row = static_cast<T*>(p.o) + b * p.o_sb +
               static_cast<long long>(row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) o_row[d] = from_float<T>(acc[d] / l_safe);
  }
}

template <typename T, int D, bool kTile>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const dim3 grid((p.sq + kBlockRows - 1) / kBlockRows, heads, batch);
  flash_fwd_kernel<T, D, staged_tile<D>(), kTile>
      <<<grid, kBlockRows, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kTile>
int dispatch(const Params& p, int batch, int heads, int head_dim, int dtype,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != T2R_HEAD_DIM) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, T2R_HEAD_DIM, kTile>(p, batch, heads, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16, T2R_HEAD_DIM, kTile>(p, batch, heads, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16; head_dim must be this library's T2R_HEAD_DIM. Strides are
// in elements; the head dim must be contiguous. window <= 0 means no
// window. Each returns the cudaError_t of its launch.

// B2: o (input dtype) = normalized attention.
extern "C" int t2r_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int sk, int head_dim, int dtype, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    int window, int q_offset, int k_offset, void* stream) {
  const Params p{q,    k,    v,    o,    nullptr, nullptr, q_sb,  q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb,    v_ss,    v_sh,  o_sb,
                 o_ss, o_sh, sq,   sk,   scale,   causal,  window, q_offset,
                 k_offset};
  return dispatch<false>(p, batch, heads, head_dim, dtype, stream);
}

// B1: o (f32, unnormalized), l and m (f32, contiguous [B, H, Sq]).
extern "C" int t2r_flash_fwd_tile(
    const void* q, const void* k, const void* v, float* o, float* l,
    float* m, int batch, int heads, int sq, int sk, int head_dim, int dtype,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, int q_offset, int k_offset,
    void* stream) {
  const Params p{q,    k,    v,    o,    l,     m,      q_sb,   q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb,  v_ss,   v_sh,   o_sb,
                 o_ss, o_sh, sq,   sk,   scale, causal, window, q_offset,
                 k_offset};
  return dispatch<true>(p, batch, heads, head_dim, dtype, stream);
}
