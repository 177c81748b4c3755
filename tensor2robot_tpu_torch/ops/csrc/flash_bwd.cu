// Flash-attention backward for Hopper, sm_90a: the dq and the dk/dv halves.
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
// rowsum(dO * O), all in f32; outputs are f32 [B, S, H, D].
//
// What bounds them on an H100. At the transformer-BC training shape
// (B=8, S=1024, H=8, D=32, causal, f32; 33.6 M visible pairs) dq does
// 6*D flops per visible pair (s, dP, dQ: 6.4 GFLOP, 96 us at the 67 TFLOP/s
// f32 peak) and dkv 8*D (s, dP, dV, dK: 8.6 GFLOP, 128 us), against
// 34-50 MB of operands (10-15 us at 3.35 TB/s): bound by operations. f32
// FMA throughout (no TF32: the JAX package asks Precision.HIGHEST and its
// gradient tests hold 2e-5); bf16 inputs are widened on load.
//
// Design, simple and right first:
//   * dq: one block per (q-tile of 64 rows, head, batch), one thread per
//     query row holding its pre-scaled q row, dO row, lse, delta and dq
//     accumulator in registers; k/v tiles staged in shared memory and read
//     at one address by all threads (broadcast); dq is scaled once at the
//     end (the dS K sum carries no factor of scale yet).
//   * dkv: one block per (k-tile of 64 keys, head, batch), one thread per
//     key holding its k and v rows and dk, dv accumulators; q (pre-scaled),
//     dO, lse and delta tiles staged in shared memory. dk takes its single
//     factor of scale from the pre-scaled q; it is not applied again.
//   * No atomics: each output row is owned by one thread, so the result
//     is the same from run to run.
//   * Masking selects (visible ? exp(s - lse) : 0), never multiplies: an
//     invisible future key with a large logit, or a fully masked row whose
//     lse is the cap, would give inf * 0 = NaN.
//   * Ragged tails: rows past Sq add nothing to dk/dv, keys past Sk nothing
//     to dq, and lse/delta are never read out of range.

#include "flash_common.cuh"

namespace {

using namespace t2r;

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
  int sq, sk;
  float scale;
  int causal, window, q_offset, k_offset;
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kBlockRows) flash_bwd_dq_kernel(const Params p) {
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
  float dout[D];
  float dq[D];
  float lse = 0.f;
  float delta = 0.f;
  if (row_valid) {
    const T* q_row = static_cast<const T*>(p.q) + b * p.q_sb +
                     static_cast<long long>(row) * p.q_ss + h * p.q_sh;
    const T* do_row = static_cast<const T*>(p.dout) + b * p.do_sb +
                      static_cast<long long>(row) * p.do_ss + h * p.do_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = to_float(q_row[d]) * p.scale;
      dout[d] = to_float(do_row[d]);
    }
    const long long stat =
        (static_cast<long long>(b) * gridDim.y + h) * p.sq + row;
    lse = p.lse[stat];
    delta = p.delta[stat];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = dout[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  // The forward's k-tile bounds (_k_block_bounds), from the tile's last
  // real row.
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

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float* k_row = k_tile + c * D;
      const float* v_row = v_tile + c * D;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], k_row[d], s);
        dp = fmaf(dout[d], v_row[d], dp);
      }
      const int key = key0 + c;
      const bool ok = row_valid && visible(key < p.sk, q_pos, p.k_offset + key,
                                           p.causal, p.window);
      const float pr = ok ? expf(s - lse) : 0.f;
      const float ds = pr * (dp - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, k_row[d], dq[d]);
    }
  }

  if (!row_valid) return;
  float* dq_row = p.dq + b * p.dq_sb + static_cast<long long>(row) * p.dq_ss +
                  h * p.dq_sh;
#pragma unroll
  for (int d = 0; d < D; ++d) dq_row[d] = dq[d] * p.scale;
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kBlockRows) flash_bwd_dkv_kernel(const Params p) {
  __shared__ __align__(16) float q_tile[BQ * D];
  __shared__ __align__(16) float do_tile[BQ * D];
  __shared__ float lse_tile[BQ];
  __shared__ float delta_tile[BQ];

  const int k_block = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int key = k_block * kBlockRows + tid;
  const bool key_valid = key < p.sk;

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* do_base = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat_base = (static_cast<long long>(b) * gridDim.y + h) * p.sq;

  float k[D];
  float v[D];
  float dk[D];
  float dv[D];
  if (key_valid) {
    const T* k_row = static_cast<const T*>(p.k) + b * p.k_sb +
                     static_cast<long long>(key) * p.k_ss + h * p.k_sh;
    const T* v_row = static_cast<const T*>(p.v) + b * p.v_sb +
                     static_cast<long long>(key) * p.v_ss + h * p.v_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k[d] = to_float(k_row[d]);
      v[d] = to_float(v_row[d]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) k[d] = v[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  // Visible q-tiles, the forward's relation transposed (:561-577) and
  // exact: causal keeps q-tiles whose last row is >= the block's first
  // key; the window keeps q-tiles whose first row is <= its last real key
  // + W - 1.
  const int cols = min(kBlockRows, p.sk - k_block * kBlockRows);
  const int k0 = p.k_offset + k_block * kBlockRows;
  const int k_pos = p.k_offset + key;
  const int num_qb = (p.sq + BQ - 1) / BQ;
  int i_lo = 0;
  int i_hi = num_qb;
  if (p.causal) i_lo = max(0, floor_div(k0 - p.q_offset, BQ));
  if (p.window > 0) {
    i_hi = max(0, min(num_qb, floor_div(k0 + cols - 1 + p.window - 1 -
                                            p.q_offset, BQ) + 1));
  }

  for (int i = i_lo; i < i_hi; ++i) {
    const int row0 = i * BQ;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BQ * D; idx += kBlockRows) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int row = row0 + r;
      float qv = 0.f;
      float dv_ = 0.f;
      if (row < p.sq) {
        qv = to_float(q_base[static_cast<long long>(row) * p.q_ss + d]) * p.scale;
        dv_ = to_float(do_base[static_cast<long long>(row) * p.do_ss + d]);
      }
      q_tile[idx] = qv;
      do_tile[idx] = dv_;
    }
    for (int r = tid; r < BQ; r += kBlockRows) {
      const int row = row0 + r;
      lse_tile[r] = row < p.sq ? p.lse[stat_base + row] : 0.f;
      delta_tile[r] = row < p.sq ? p.delta[stat_base + row] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float* q_row = q_tile + r * D;
      const float* do_row = do_tile + r * D;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_row[d], k[d], s);
        dp = fmaf(do_row[d], v[d], dp);
      }
      const int row = row0 + r;
      const bool ok = key_valid && visible(row < p.sq, p.q_offset + row, k_pos,
                                           p.causal, p.window);
      const float pr = ok ? expf(s - lse_tile[r]) : 0.f;
      const float ds = pr * (dp - delta_tile[r]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pr, do_row[d], dv[d]);
        dk[d] = fmaf(ds, q_row[d], dk[d]);
      }
    }
  }

  if (!key_valid) return;
  float* dk_row = p.dk + b * p.dk_sb + static_cast<long long>(key) * p.dk_ss +
                  h * p.dk_sh;
  float* dv_row = p.dv + b * p.dv_sb + static_cast<long long>(key) * p.dv_ss +
                  h * p.dv_sh;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk_row[d] = dk[d];
    dv_row[d] = dv[d];
  }
}

template <typename T>
cudaError_t launch(const Params& p, bool dkv, int batch, int heads,
                   cudaStream_t stream) {
  constexpr int D = T2R_HEAD_DIM;
  if (dkv) {
    const dim3 grid((p.sk + kBlockRows - 1) / kBlockRows, heads, batch);
    flash_bwd_dkv_kernel<T, D, staged_tile<D>()>
        <<<grid, kBlockRows, 0, stream>>>(p);
  } else {
    const dim3 grid((p.sq + kBlockRows - 1) / kBlockRows, heads, batch);
    flash_bwd_dq_kernel<T, D, staged_tile<D>()>
        <<<grid, kBlockRows, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

int dispatch(const Params& p, bool dkv, int batch, int heads, int head_dim,
             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != T2R_HEAD_DIM) return cudaErrorInvalidValue;
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
