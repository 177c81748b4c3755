// Flash-attention backward for Hopper, sm_90a: the dq and the dk/dv halves,
// on the tensor cores in split f32 (flash_mma.cuh).
//
// Replaces, from tensor2robot_tpu/ops/flash_attention.py (both launched by
// `flash_attention_bwd_tile` through pl.pallas_call, with the shared
// recompute `_bwd_tile`):
//   * `_flash_bwd_dq_kernel` -> t2r_flash_bwd_dq: the query-parallel half,
//     dQ = scale * sum_j dS K_j over the visible k-tiles;
//   * `_flash_bwd_dkv_kernel` -> t2r_flash_bwd_dkv: the key-parallel half,
//     dV = sum_i P^T dO_i and dK = sum_i dS^T (q_i * scale) over the
//     visible q-tiles (the forward's bounds transposed).
// Both recompute P = exp(q k^T * scale - lse) from the forward's row stats
// (lse = m + log l) and take dS = P * (dO V^T - delta), delta =
// rowsum(dO * O); outputs are f32 [B, S, H, D].
//
// What bounds them on an H100. At the transformer-BC training shape
// (B=8, S=1024, H=8, D=32, causal, f32; 33.6 M visible pairs) dq does
// 6*D flops per visible pair (S, dP, dQ: 6.45 GFLOP) and dkv 8*D (S, dP,
// dV, dK: 8.60 GFLOP), against 42-51 MB of operands (13-15 us at
// 3.35 TB/s): bound by operations. The products run on the tensor cores
// as three TF32 products each (split f32, as PyTorch's memory-efficient
// attention does in f32), so the least time is 3 * flops at 495 TFLOP/s:
// 39 us (dq) and 52 us (dkv). One TF32 product would miss the f32
// tolerance the JAX package holds its gradients to (2e-5 to 1e-4).
//
// Before this design each thread owned one query row (dq) or key (dkv)
// and ran scalar f32 FMAs at 64 threads a block: 0.6738 ms (dq) and
// 0.8287 ms (dkv) on an H100 80GB HBM3 at 700 W, 14-16% of the SIMT f32
// bound; this design takes 0.2943 ms and 0.3284 ms there (chip_smoke.py).
// What held the old one back, and what this design does about it:
//   * SIMT f32 FMAs -> mma.sync m16n8k8 TF32 on split operands. A block
//     of 4 warps owns 64 rows (dq) or keys (dkv), 16 per warp, so each
//     staged operand feeds 16 rows of products instead of one. A warp
//     holds S and dP for 32 keys (rows) of the staged tile at a time
//     (kChunk), which keeps it near 128 registers and 4 blocks on an SM;
//     holding the whole 64 took ~175 registers and ran slower.
//   * Accuracy: each 3-product split chain starts from zero and is added
//     to the f32 accumulator with a rounded add (mma_split_add); one long
//     chain per dq/dk/dv element drifts (the tensor cores' f32 sum is not
//     round-to-nearest) to 8e-5 at the slice shape, 10x the split error.
//   * Every element re-read from shared memory per pair -> fragments: an
//     A fragment is split once and feeds a row of n-tiles, the S and dP
//     accumulators turn into the A operand of dQ (dV, dK) with no data
//     movement (flash_mma.cuh: acc_as_a), and tiles are padded to D + 4
//     words so fragment loads hit 32 distinct banks.
//   * Synchronous staging -> cp.async 16-byte copies, double-buffered: the
//     next k-tile (dq) or q-tile (dkv) loads while this one computes.
//     Inputs that are bf16, or f32 views not on 16 bytes, are staged with
//     plain loads into the same buffers (bf16 widened exactly to f32).
//   * Causal imbalance -> the q-tile or k-tile index is the grid's slowest
//     dimension, heaviest first (dq walks its q-tiles from the last, dkv
//     its k-tiles from the first), so the long blocks start earliest; and
//     a warp skips each 8-wide n-tile that no pair of its 16 rows sees.
//
// Rules kept from the Pallas kernels:
//   * No atomics: every output row is written by one warp of one block,
//     so dq, dk and dv are the same bits from run to run.
//   * Masking selects (visible ? exp(s - lse) : 0), never multiplies: an
//     invisible future key with a large logit, or a fully masked row whose
//     lse is the cap, would give inf * 0 = NaN. A masked row's dq is 0.
//   * Ragged tails: rows past Sq and keys past Sk are staged as zeros and
//     masked, and lse/delta are never read out of range.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2r;

constexpr int kWarps = kBlockRows / 16;
constexpr int kThreads = 32 * kWarps;
// n-tiles of 8 keys (dq) or 8 rows (dkv) whose S and dP a warp holds in
// registers at a time: a chunk of 32 of the staged tile.
constexpr int kChunk = 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  float* dq;
  float* dk;
  float* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int heads, sq, sk;
  float scale;
  int causal, window, q_offset, k_offset;
  // f32 inputs whose rows all start on 16 bytes: staged with cp.async.
  int async_ok;
};

template <int D, int BK>
__host__ __device__ constexpr int dq_smem_bytes() {
  // q and dO of the block, then two stages of (k, v).
  return (2 * kBlockRows + 2 * 2 * BK) * (D + kPad) * 4;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int NT = BK / 8;  // 8-key n-tiles of S and dP
  constexpr int NC = NT < kChunk ? NT : kChunk;
  constexpr int KD = D / 8;   // k-steps over D; 8-wide n-tiles of dQ
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = s_q + kBlockRows * LD;
  float* s_kv = s_do + kBlockRows * LD;  // stage s: k at 2*s*BK*LD, v after

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_block = gridDim.z - 1 - blockIdx.z;  // the longest walks first
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int row0 = q_block * kBlockRows;
  const int wr = warp * 16;  // the warp's first row in the block

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* do_base = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bool async_ok = p.async_ok;

  stage_rows<T, D, kBlockRows, kThreads>(s_q, q_base, p.q_ss, row0, p.sq,
                                         async_ok);
  stage_rows<T, D, kBlockRows, kThreads>(s_do, do_base, p.do_ss, row0, p.sq,
                                         async_ok);
  cp_async_commit();

  // This thread's two rows, g and g + 8 of the warp's 16.
  const int row_a = row0 + wr + g;
  const int row_b = row_a + 8;
  const long long stat = (static_cast<long long>(b) * p.heads + h) * p.sq;
  const float lse_a = row_a < p.sq ? p.lse[stat + row_a] : 0.f;
  const float lse_b = row_b < p.sq ? p.lse[stat + row_b] : 0.f;
  const float delta_a = row_a < p.sq ? p.delta[stat + row_a] : 0.f;
  const float delta_b = row_b < p.sq ? p.delta[stat + row_b] : 0.f;

  // The forward's k-tile bounds (_k_block_bounds), from the tile's last
  // real row.
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

  float dq[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

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

    // The tile in chunks of NC n-tiles of 8 keys: S and dP of one chunk
    // stay in registers at a time.
#pragma unroll 1
    for (int c0 = 0; c0 < NT; c0 += NC) {
      const int key0 = j * BK + 8 * c0;
      const float* k_chunk = s_k + 8 * c0 * LD;
      const float* v_chunk = s_v + 8 * c0 * LD;
      // Per n-tile: any pair visible (else skipped), every pair visible
      // (no per-pair test).
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

      // S = (q * scale) K^T and dP = dO V^T for the warp's 16 rows.
      float s[NC][4];
      float dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        const FragA aq = load_a(s_q + wr * LD + 8 * ks, LD, g, t, p.scale);
        const FragA ado = load_a(s_do + wr * LD + 8 * ks, LD, g, t, 1.f);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (!live[n]) continue;
          mma_split(s[n], aq, load_b_nk(k_chunk + 8 * n * LD + 8 * ks, LD, g, t));
          mma_split(dp[n], ado, load_b_nk(v_chunk + 8 * n * LD + 8 * ks, LD, g, t));
        }
      }

      // P and dS in place of S.
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (!live[n]) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = c < 2 ? row_a : row_b;
          const int key = key0 + 8 * n + 2 * t + (c & 1);
          const bool ok = full[n] || visible(key < p.sk && row < p.sq,
                                             p.q_offset + row, p.k_offset + key,
                                             p.causal, p.window);
          const float pr = ok ? expf(s[n][c] - (c < 2 ? lse_a : lse_b)) : 0.f;
          s[n][c] = pr * (dp[n][c] - (c < 2 ? delta_a : delta_b));
        }
      }

      // dQ += dS K.
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (!live[n]) continue;
        const FragA ads = acc_as_a(s[n]);
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          mma_split_add(dq[d], ads,
                        load_b_kn(k_chunk + 8 * n * LD + 8 * d, LD, g, t));
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty walk)

  float* dq_base = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int d = 0; d < KD; ++d) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = c < 2 ? row_a : row_b;
      if (row < p.sq) {
        dq_base[static_cast<long long>(row) * p.dq_ss + 8 * d + 2 * t + (c & 1)] =
            dq[d][c] * p.scale;
      }
    }
  }
}

template <int D, int BQ>
__host__ __device__ constexpr int dkv_stage_floats() {
  // q and dO tiles, then lse and delta.
  return 2 * BQ * (D + kPad) + 2 * BQ;
}

template <int D, int BQ>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // k and v of the block, then two stages.
  return (2 * kBlockRows * (D + kPad) + 2 * dkv_stage_floats<D, BQ>()) * 4;
}

template <typename T, int D, int BQ>
__device__ __forceinline__ void stage_q_tile(float* stage, const T* q_base,
                                             long long q_ss, const T* do_base,
                                             long long do_ss, const float* lse,
                                             const float* delta, int sq, int r0,
                                             bool async_ok) {
  constexpr int LD = D + kPad;
  stage_rows<T, D, BQ, kThreads>(stage, q_base, q_ss, r0, sq, async_ok);
  stage_rows<T, D, BQ, kThreads>(stage + BQ * LD, do_base, do_ss, r0, sq,
                                 async_ok);
  float* s_lse = stage + 2 * BQ * LD;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = r0 + r;
    const bool ok = row < sq;
    cp_async4(s_lse + r, ok ? lse + row : lse, ok);
    cp_async4(s_lse + BQ + r, ok ? delta + row : delta, ok);
  }
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int NT = BQ / 8;  // 8-row n-tiles of S^T and dP^T
  constexpr int NC = NT < kChunk ? NT : kChunk;
  constexpr int KD = D / 8;
  constexpr int kStage = dkv_stage_floats<D, BQ>();
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + kBlockRows * LD;
  float* s_stages = s_v + kBlockRows * LD;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k_block = blockIdx.z;  // under causal masking the first walk longest
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int key_block0 = k_block * kBlockRows;
  const int wk = warp * 16;  // the warp's first key in the block

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* do_base = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long stat = (static_cast<long long>(b) * p.heads + h) * p.sq;
  const float* lse = p.lse + stat;
  const float* delta = p.delta + stat;
  const bool async_ok = p.async_ok;

  stage_rows<T, D, kBlockRows, kThreads>(s_k, k_base, p.k_ss, key_block0,
                                         p.sk, async_ok);
  stage_rows<T, D, kBlockRows, kThreads>(s_v, v_base, p.v_ss, key_block0,
                                         p.sk, async_ok);
  cp_async_commit();

  // Visible q-tiles, the forward's relation transposed (:561-577) and
  // exact: causal keeps q-tiles whose last row is >= the block's first
  // key; the window keeps q-tiles whose first row is <= its last real key
  // + W - 1.
  const int cols = min(kBlockRows, p.sk - key_block0);
  const int k0 = p.k_offset + key_block0;
  const int num_qb = (p.sq + BQ - 1) / BQ;
  int i_lo = 0;
  int i_hi = num_qb;
  if (p.causal) i_lo = max(0, floor_div(k0 - p.q_offset, BQ));
  if (p.window > 0) {
    i_hi = max(0, min(num_qb, floor_div(k0 + cols - 1 + p.window - 1 -
                                            p.q_offset, BQ) + 1));
  }

  // This thread's two keys, g and g + 8 of the warp's 16.
  const int key_a = key_block0 + wk + g;
  const int key_b = key_a + 8;
  float dk[KD][4];
  float dv[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[d][c] = dv[d][c] = 0.f;
  }

  if (i_lo < i_hi) {
    stage_q_tile<T, D, BQ>(s_stages, q_base, p.q_ss, do_base, p.do_ss, lse,
                           delta, p.sq, i_lo * BQ, async_ok);
  }
  cp_async_commit();

  const int wk_lo = k0 + wk;  // the warp's key positions
  const bool warp_keys = key_block0 + wk < p.sk;
  const bool warp_full = key_block0 + wk + 15 < p.sk;
  for (int i = i_lo; i < i_hi; ++i) {
    const float* stage = s_stages + ((i - i_lo) & 1) * kStage;
    const float* s_q = stage;
    const float* s_do = stage + BQ * LD;
    const float* s_lse = stage + 2 * BQ * LD;
    const float* s_delta = s_lse + BQ;
    if (i + 1 < i_hi) {
      stage_q_tile<T, D, BQ>(s_stages + ((i + 1 - i_lo) & 1) * kStage, q_base,
                             p.q_ss, do_base, p.do_ss, lse, delta, p.sq,
                             (i + 1) * BQ, async_ok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // The tile in chunks of NC n-tiles of 8 rows.
#pragma unroll 1
    for (int c0 = 0; c0 < NT; c0 += NC) {
      const int r0 = i * BQ + 8 * c0;
      const float* q_chunk = s_q + 8 * c0 * LD;
      const float* do_chunk = s_do + 8 * c0 * LD;
      const float* lse_chunk = s_lse + 8 * c0;
      const float* delta_chunk = s_delta + 8 * c0;
      bool live[NC];
      bool full[NC];
      bool any = false;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int r_lo = p.q_offset + r0 + 8 * n;
        live[n] = warp_keys && r0 + 8 * n < p.sq &&
                  any_visible(r_lo, r_lo + 7, wk_lo, wk_lo + 15, p.causal,
                              p.window);
        full[n] = warp_full && r0 + 8 * n + 7 < p.sq &&
                  all_visible(r_lo, r_lo + 7, wk_lo, wk_lo + 15, p.causal,
                              p.window);
        any = any || live[n];
      }
      if (!any) continue;

      // S^T = K q^T (times scale below) and dP^T = V dO^T for the warp's
      // 16 keys.
      float st[NC][4];
      float dpt[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        const FragA ak = load_a(s_k + wk * LD + 8 * ks, LD, g, t, 1.f);
        const FragA av = load_a(s_v + wk * LD + 8 * ks, LD, g, t, 1.f);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (!live[n]) continue;
          mma_split(st[n], ak, load_b_nk(q_chunk + 8 * n * LD + 8 * ks, LD, g, t));
          mma_split(dpt[n], av,
                    load_b_nk(do_chunk + 8 * n * LD + 8 * ks, LD, g, t));
        }
      }

      // P^T in place of S^T, dS^T in place of dP^T.
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (!live[n]) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = c < 2 ? key_a : key_b;
          const int col = 8 * n + 2 * t + (c & 1);
          const int row = r0 + col;
          const bool ok = full[n] || visible(key < p.sk && row < p.sq,
                                             p.q_offset + row, p.k_offset + key,
                                             p.causal, p.window);
          const float pr =
              ok ? expf(st[n][c] * p.scale - lse_chunk[col]) : 0.f;
          st[n][c] = pr;
          dpt[n][c] = pr * (dpt[n][c] - delta_chunk[col]);
        }
      }

      // dV += P^T dO and dK += dS^T q (scale applied once at the end).
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (!live[n]) continue;
        const FragA ap = acc_as_a(st[n]);
        const FragA ads = acc_as_a(dpt[n]);
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          mma_split_add(dv[d], ap,
                        load_b_kn(do_chunk + 8 * n * LD + 8 * d, LD, g, t));
          mma_split_add(dk[d], ads,
                        load_b_kn(q_chunk + 8 * n * LD + 8 * d, LD, g, t));
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty walk)

  float* dk_base = p.dk + b * p.dk_sb + h * p.dk_sh;
  float* dv_base = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int d = 0; d < KD; ++d) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = c < 2 ? key_a : key_b;
      if (key < p.sk) {
        const int col = 8 * d + 2 * t + (c & 1);
        dk_base[static_cast<long long>(key) * p.dk_ss + col] = dk[d][c] * p.scale;
        dv_base[static_cast<long long>(key) * p.dv_ss + col] = dv[d][c];
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int smem, dim3 grid, const Params& p,
                          cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, bool dkv, int batch, int heads,
                   cudaStream_t stream) {
  constexpr int D = T2R_HEAD_DIM;
  constexpr int kTile = staged_tile<D>();
  const int blocks = ((dkv ? p.sk : p.sq) + kBlockRows - 1) / kBlockRows;
  if (blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(heads, batch, blocks);
  if (dkv) {
    return launch_kernel(flash_bwd_dkv_kernel<T, D, kTile>,
                         dkv_smem_bytes<D, kTile>(), grid, p, stream);
  }
  return launch_kernel(flash_bwd_dq_kernel<T, D, kTile>,
                       dq_smem_bytes<D, kTile>(), grid, p, stream);
}

int dispatch(Params& p, bool dkv, int batch, int heads, int head_dim,
             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != T2R_HEAD_DIM) return cudaErrorInvalidValue;
  p.heads = heads;
  p.async_ok = dtype == 0 &&
               rows_on_16_bytes(p.q, p.q_sb, p.q_ss, p.q_sh) &&
               rows_on_16_bytes(p.k, p.k_sb, p.k_ss, p.k_sh) &&
               rows_on_16_bytes(p.v, p.v_sb, p.v_ss, p.v_sh) &&
               rows_on_16_bytes(p.dout, p.do_sb, p.do_ss, p.do_sh);
  if (dtype == 0) return launch<float>(p, dkv, batch, heads, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, dkv, batch, heads, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes). q/k/v/dout: dtype 0 = float32,
// 1 = bfloat16, [B, S, H, D] by element strides with the head dim
// contiguous; lse and delta: contiguous f32 [B, H, Sq]; outputs f32 by
// strides. head_dim must be this library's T2R_HEAD_DIM; window <= 0 means
// no window. Each returns the cudaError_t of its launch.

// B3: dq (f32) from q, k, v, dout, lse, delta.
extern "C" int t2r_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq, int batch, int heads,
    int sq, int sk, int head_dim, int dtype, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dq_sb, long long dq_ss,
    long long dq_sh, float scale, int causal, int window, int q_offset,
    int k_offset, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.sq = sq; p.sk = sk; p.scale = scale; p.causal = causal;
  p.window = window; p.q_offset = q_offset; p.k_offset = k_offset;
  return dispatch(p, false, batch, heads, head_dim, dtype, stream);
}

// B4: dk and dv (f32) from q, k, v, dout, lse, delta.
extern "C" int t2r_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dk, float* dv, int batch,
    int heads, int sq, int sk, int head_dim, int dtype, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, float scale, int causal, int window, int q_offset,
    int k_offset, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.sq = sq; p.sk = sk; p.scale = scale; p.causal = causal;
  p.window = window; p.q_offset = q_offset; p.k_offset = k_offset;
  return dispatch(p, true, batch, heads, head_dim, dtype, stream);
}
