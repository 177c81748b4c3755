// Warp-level tensor-core pieces of the flash backward (flash_bwd.cu): the
// split-f32 (3xTF32) m16n8k8 product, its operand fragments, and the
// cp.async copies that stage tiles into shared memory.
//
// Split f32. Each f32 operand x is cut into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero
// (cvt.rna); the product a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
// accumulated in f32. It drops only lo_a*lo_b (~2^-22 of |a*b|), so the
// result keeps f32 accuracy, where one TF32 product keeps ~2^-11.
//
// Fragment layout of mma.sync.m16n8k8 (tf32), g = lane / 4, t = lane % 4:
//   A (16x8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8, col):  b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16x8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// A product over k is a sum, so the k index may be permuted as long as A
// and B agree. Taking k-slot t as column 2t and slot t+4 as column 2t+1
// turns an accumulator (c0, c2, c1, c3) into an A fragment with no data
// movement (acc_as_a); B is then read from rows 2t and 2t+1 (load_b_kn).
#pragma once

#include <cstdint>

namespace t2r {

// Row padding of the f32 tiles in shared memory: with a row stride of
// D + 4 words, both B-fragment patterns below (and the A loads) hit 32
// distinct banks, and each row still starts on 16 bytes for cp.async.
constexpr int kPad = 4;

struct FragA {
  uint32_t hi[4];
  uint32_t lo[4];
};

struct FragB {
  uint32_t hi[2];
  uint32_t lo[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA make_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// A from 16 rows x 8 columns of a row-major tile (row stride ld),
// each element times `mul`.
__device__ __forceinline__ FragA load_a(const float* tile, int ld, int g, int t,
                                        float mul) {
  return make_a(tile[g * ld + t] * mul, tile[(g + 8) * ld + t] * mul,
                tile[g * ld + t + 4] * mul, tile[(g + 8) * ld + t + 4] * mul);
}

// B(k, n) = tile[n][k]: 8 rows (n) x 8 columns (k) of a row-major tile,
// as K^T in S = Q K^T.
__device__ __forceinline__ FragB load_b_nk(const float* tile, int ld, int g, int t) {
  return make_b(tile[g * ld + t], tile[g * ld + t + 4]);
}

// B(k, n) = tile[k][n] with the permuted k of acc_as_a: rows 2t and 2t+1,
// column g, as K in dQ = dS K.
__device__ __forceinline__ FragB load_b_kn(const float* tile, int ld, int g, int t) {
  return make_b(tile[2 * t * ld + g], tile[(2 * t + 1) * ld + g]);
}

// An accumulator as the A operand of the next product (permuted k).
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return make_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split f32: the two small cross terms first, then hi*hi.
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc += a b in split f32 through a fresh accumulator, added to acc with
// one rounded f32 add per element. The tensor cores' f32 accumulation is
// not IEEE round-to-nearest: over a chain of hundreds of products into one
// accumulator (a k or v row summed over 1024 queries) its error grows with
// the chain; here each chain is three products long.
__device__ __forceinline__ void mma_split_add(float (&acc)[4], const FragA& a,
                                              const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split(d, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// 16-byte (4-byte) asynchronous copy global -> shared; with valid false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace t2r
