// Flash-attention forward for Hopper, sm_90a: two kernels of one body, on
// the tensor cores in split f32 (flash_mma.cuh).
//
// Replaces, from tensor2robot_tpu/ops/flash_attention.py (both built on the
// shared body `_flash_body`):
//   * `_flash_kernel` (launched by `_flash_attention_fwd_impl` through
//     pl.pallas_call) -> t2r_flash_fwd (B2): the NORMALIZED output
//     o = softmax(q k^T * scale) v, cast to the input dtype, with the row
//     sum floored at 1e-30 (a row that sees no key comes out 0); the
//     forward used when no gradient is taken.
//   * `_flash_tile_kernel` (launched by `flash_attention_tile`) ->
//     t2r_flash_fwd_tile (B1): the same recurrence emitting the
//     UNNORMALIZED f32 accumulator o with the row stats l (sum) and m (max)
//     in [B, H, Sq] f32, the training forward's residuals (lse = m + log l).
// Both take [B, S, H, D] by strides, causal and causal-sliding-window masks
// in GLOBAL positions (q_offset, k_offset), an online softmax in f32 with
// the finite cap -1e30, and a row that has seen no visible key
// contributing exactly 0.
//
// What bounds them on an H100. At the transformer-BC shape (B=8, S=1024,
// H=8, D=32, causal, f32; 33.6 M visible pairs) the work is 4*D flops per
// visible pair (S = q k^T and O += P V), 4.299 GFLOP, against 33.5 MB of
// q, k, v and o (~10 us at 3.35 TB/s): bound by operations. f32 inputs
// keep f32 accuracy (the JAX package asks for Precision.HIGHEST, and one
// TF32 product misses its 2e-5), so each product runs as three TF32
// products (split f32): the least time is 3 * 4.299 GFLOP at 495 TFLOP/s,
// 0.0261 ms. bf16 inputs are widened exactly to f32 on staging.
//
// The first design gave each thread one query row and ran scalar f32
// FMAs: B1 0.4659 ms and B2 0.4557 ms on an H100 80GB HBM3 at 700 W, 1.5x
// PyTorch's attention calls for the same functions (~0.31 ms). This design
// takes B1 0.2266 ms and B2 0.2255 ms on the same card and limit, under
// those calls' 0.3108 and 0.3123 ms, at 11.5% of the split-f32 bound
// (chip_smoke.py; PERF.md keeps the later runs). What held the old one
// back, and what this design does about it:
//   * SIMT f32 FMAs, one row a thread -> mma.sync m16n8k8 TF32 on split
//     operands. A block of 4 warps owns 64 query rows, 16 a warp, so each
//     staged k and v element feeds 16 rows from one register fragment
//     instead of being read again from shared memory by every row.
//   * q[D] and acc[D] in each thread's registers (spills at D = 64, 128)
//     -> the O fragment is D/2 floats a thread and S of one chunk 16; q's
//     A fragments are read from shared memory per k-step.
//   * Synchronous staging -> cp.async 16-byte copies, double-buffered: the
//     next k/v tile loads while this one computes. bf16 inputs, or f32
//     views whose rows are not on 16 bytes, take plain loads into the same
//     tiles (decided per launch). Rows are padded to D + 4 words.
//   * Causal imbalance -> the q-tile index is the grid's slowest
//     dimension, walked from the last, so the longest walks start first;
//     a warp skips each 8-key n-tile that none of its 16 rows sees, and
//     the per-pair test on n-tiles whose pairs are all visible.
//
// The softmax in the accumulator layout. A thread holds rows g and g+8 of
// its warp's 16, at columns 2t and 2t+1 of each n-tile. Per chunk of 32
// keys (one online-softmax step):
//   * the row maximum is taken over the thread's columns, then over the
//     four lanes of its quad (shuffles), before any exp: O += P V sums over
//     all four lanes' columns, so the four must share one scale;
//   * a row whose maximum is still the cap has seen no visible key: its p
//     is 0, not exp(0);
//   * alpha = exp(m - m_new) rescales the row's O fragment and its l;
//   * l stays the thread's partial sum over its own columns, rescaled by
//     the same alpha, and is summed over the quad once at the end.
// O += P V: the S accumulator is the A operand of P V as it stands
// (acc_as_a), and each 3-product chain starts from zero and is added into
// O with a rounded f32 add (mma_split_add): one long chain per O element
// drifts past B2's 2e-5. The k-tiles walked are exactly those of
// `_k_block_bounds` at staged_tile<D>() keys, as the plain versions walk
// them; stepping the softmax per 32-key chunk where the plain version
// steps per tile changes the rounding only.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2r;

constexpr int kWarps = kBlockRows / 16;
constexpr int kThreads = 32 * kWarps;
// n-tiles of 8 keys whose S a warp holds in registers at a time: a chunk
// of 32 keys of the staged tile, one online-softmax step.
constexpr int kChunk = 4;
constexpr unsigned kAllLanes = 0xffffffffu;

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
  int heads, sq, sk;
  float scale;
  int causal, window, q_offset, k_offset;
  // f32 inputs whose rows all start on 16 bytes: staged with cp.async.
  int async_ok;
};

template <int D, int BK>
__host__ __device__ constexpr int smem_bytes() {
  // q of the block, then two stages of (k, v).
  return (kBlockRows + 2 * 2 * BK) * (D + kPad) * 4;
}

// Over the four lanes of a quad, which hold one row's columns.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kAllLanes, x, 1));
  return fmaxf(x, __shfl_xor_sync(kAllLanes, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kAllLanes, x, 1);
  return x + __shfl_xor_sync(kAllLanes, x, 2);
}

// kTile = false: normalized output of type T (B2). kTile = true: the raw
// f32 accumulator and the row stats (B1).
template <typename T, int D, int BK, bool kTile>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int NT = BK / 8;  // 8-key n-tiles of S
  constexpr int NC = NT < kChunk ? NT : kChunk;
  constexpr int KD = D / 8;   // k-steps over D; 8-wide n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_kv = s_q + kBlockRows * LD;  // stage s: k at 2*s*BK*LD, v after

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_block = gridDim.z - 1 - blockIdx.z;  // the longest walks first
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int row0 = q_block * kBlockRows;
  const int wr = warp * 16;  // the warp's first row in the block

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bool async_ok = p.async_ok;

  stage_rows<T, D, kBlockRows, kThreads>(s_q, q_base, p.q_ss, row0, p.sq,
                                         async_ok);
  cp_async_commit();

  // Visible k-tiles: exact per tile, as _k_block_bounds, with the causal
  // bound taken from the tile's last REAL row (ragged tail).
  const int rows = min(kBlockRows, p.sq - row0);
  const int q0 = p.q_offset + row0;
  const int num_kb = (p.sk + BK - 1) / BK;
  int j_lo = 0;
  int j_hi = num_kb;
  if (p.causal) {
    j_hi = max(0, min(num_kb, floor_div(q0 + rows - 1 - p.k_offset, BK) + 1));
  }
  if (p.window > 0) {
    j_lo = max(0, floor_div(q0 - p.window + 1 - p.k_offset, BK));
  }

  // This thread's two rows, g and g + 8 of the warp's 16: the O fragment
  // (c0, c1 row a; c2, c3 row b), the running maxima and partial sums.
  const int row_a = row0 + wr + g;
  const int row_b = row_a + 8;
  float o[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = kNegInf;
  float m_b = kNegInf;
  float l_a = 0.f;
  float l_b = 0.f;

  if (j_lo < j_hi) {
    stage_rows<T, D, BK, kThreads>(s_kv, k_base, p.k_ss, j_lo * BK, p.sk,
                                   async_ok);
    stage_rows<T, D, BK, kThreads>(s_kv + BK * LD, v_base, p.v_ss, j_lo * BK,
                                   p.sk, async_ok);
  }
  cp_async_commit();

  const int wq_lo = p.q_offset + row0 + wr;  // the warp's row positions
  const bool warp_rows = row0 + wr < p.sq;
  const bool warp_full = row0 + wr + 15 < p.sq;
  for (int j = j_lo; j < j_hi; ++j) {
    const float* s_k = s_kv + ((j - j_lo) & 1) * 2 * BK * LD;
    const float* s_v = s_k + BK * LD;
    if (j + 1 < j_hi) {
      float* next = s_kv + ((j + 1 - j_lo) & 1) * 2 * BK * LD;
      stage_rows<T, D, BK, kThreads>(next, k_base, p.k_ss, (j + 1) * BK, p.sk,
                                     async_ok);
      stage_rows<T, D, BK, kThreads>(next + BK * LD, v_base, p.v_ss,
                                     (j + 1) * BK, p.sk, async_ok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // The tile in chunks of NC n-tiles of 8 keys, one softmax step each.
#pragma unroll 1
    for (int c0 = 0; c0 < NT; c0 += NC) {
      const int key0 = j * BK + 8 * c0;
      const float* k_chunk = s_k + 8 * c0 * LD;
      const float* v_chunk = s_v + 8 * c0 * LD;
      // Per n-tile: any pair visible (else skipped), every pair visible
      // (no per-pair test). A chunk no pair of the warp sees changes
      // nothing: it would leave m as it is and add p = 0.
      bool live[NC];
      bool full[NC];
      bool any = false;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c_lo = p.k_offset + key0 + 8 * n;
        live[n] = warp_rows && key0 + 8 * n < p.sk &&
                  any_visible(wq_lo, wq_lo + 15, c_lo, c_lo + 7, p.causal,
                              p.window);
        full[n] = warp_full && key0 + 8 * n + 7 < p.sk &&
                  all_visible(wq_lo, wq_lo + 15, c_lo, c_lo + 7, p.causal,
                              p.window);
        any = any || live[n];
      }
      if (!any) continue;

      // S = (q * scale) K^T for the warp's 16 rows.
      float s[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        const FragA aq = load_a(s_q + wr * LD + 8 * ks, LD, g, t, p.scale);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (!live[n]) continue;
          mma_split(s[n], aq, load_b_nk(k_chunk + 8 * n * LD + 8 * ks, LD, g, t));
        }
      }

      // Masked logits to the cap, then each row's maximum over the quad.
      float mx_a = kNegInf;
      float mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = c < 2 ? row_a : row_b;
          const int key = key0 + 8 * n + 2 * t + (c & 1);
          const bool ok =
              live[n] && (full[n] || visible(key < p.sk && row < p.sq,
                                             p.q_offset + row, p.k_offset + key,
                                             p.causal, p.window));
          s[n][c] = ok ? s[n][c] : kNegInf;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = expf(m_a - mn_a);
      const float alpha_b = expf(m_b - mn_b);
      // A row that has seen no visible key keeps m at the cap: its masked
      // keys contribute nothing (not exp(0) = 1 each).
      const bool dead_a = mn_a == kNegInf;
      const bool dead_b = mn_b == kNegInf;

      // P in place of S; this thread's part of the row sums.
      float sum_a = 0.f;
      float sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[n][c] = dead_a ? 0.f : expf(s[n][c] - mn_a);
          s[n][c + 2] = dead_b ? 0.f : expf(s[n][c + 2] - mn_b);
          sum_a += s[n][c];
          sum_b += s[n][c + 2];
        }
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;

      // O = alpha O + P V.
#pragma unroll
      for (int d = 0; d < KD; ++d) {
        o[d][0] *= alpha_a;
        o[d][1] *= alpha_a;
        o[d][2] *= alpha_b;
        o[d][3] *= alpha_b;
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (!live[n]) continue;
        const FragA ap = acc_as_a(s[n]);
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          mma_split_add(o[d], ap,
                        load_b_kn(v_chunk + 8 * n * LD + 8 * d, LD, g, t));
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty walk)

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const long long o_off = b * p.o_sb + h * p.o_sh;
  if constexpr (kTile) {
    float* o_base = static_cast<float*>(p.o) + o_off;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = c < 2 ? row_a : row_b;
        if (row < p.sq) {
          o_base[static_cast<long long>(row) * p.o_ss + 8 * d + 2 * t + (c & 1)] =
              o[d][c];
        }
      }
    }
    if (t == 0) {
      const long long stat = (static_cast<long long>(b) * p.heads + h) * p.sq;
      if (row_a < p.sq) {
        p.l[stat + row_a] = l_a;
        p.m[stat + row_a] = m_a;
      }
      if (row_b < p.sq) {
        p.l[stat + row_b] = l_b;
        p.m[stat + row_b] = m_b;
      }
    }
  } else {
    const float l_safe_a = fmaxf(l_a, 1e-30f);
    const float l_safe_b = fmaxf(l_b, 1e-30f);
    T* o_base = static_cast<T*>(p.o) + o_off;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = c < 2 ? row_a : row_b;
        if (row < p.sq) {
          o_base[static_cast<long long>(row) * p.o_ss + 8 * d + 2 * t + (c & 1)] =
              from_float<T>(o[d][c] / (c < 2 ? l_safe_a : l_safe_b));
        }
      }
    }
  }
}

template <typename T, bool kTile>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int D = T2R_HEAD_DIM;
  constexpr int BK = staged_tile<D>();
  constexpr int smem = smem_bytes<D, BK>();
  const int blocks = (p.sq + kBlockRows - 1) / kBlockRows;
  if (blocks > 65535) return cudaErrorInvalidValue;
  const auto kernel = flash_fwd_kernel<T, D, BK, kTile>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, batch, blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kTile>
int dispatch(Params& p, int batch, int heads, int head_dim, int dtype,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != T2R_HEAD_DIM) return cudaErrorInvalidValue;
  p.heads = heads;
  p.async_ok = dtype == 0 &&
               rows_on_16_bytes(p.q, p.q_sb, p.q_ss, p.q_sh) &&
               rows_on_16_bytes(p.k, p.k_sb, p.k_ss, p.k_sh) &&
               rows_on_16_bytes(p.v, p.v_sb, p.v_ss, p.v_sh);
  if (dtype == 0) return launch<float, kTile>(p, batch, heads, s);
  if (dtype == 1) return launch<__nv_bfloat16, kTile>(p, batch, heads, s);
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
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq; p.sk = sk; p.scale = scale; p.causal = causal;
  p.window = window; p.q_offset = q_offset; p.k_offset = k_offset;
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
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.l = l; p.m = m;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq; p.sk = sk; p.scale = scale; p.causal = causal;
  p.window = window; p.q_offset = q_offset; p.k_offset = k_offset;
  return dispatch<true>(p, batch, heads, head_dim, dtype, stream);
}
