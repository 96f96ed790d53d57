// Warp-level tensor-core products for the port's fp32 kernels (sm_90a).
//
// The kernels that include this header hold the reference's fp32 bars
// (flash 2e-5 / 2e-4, SSD 2e-4 / 2e-3).  One TF32 product keeps 10 bits of
// mantissa and misses both; three do not: each fp32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), and a product is summed as
// hi.hi + (lo.hi + hi.lo) in fp32 accumulators (3xTF32, about 22 bits; the
// dropped lo.lo term is below fp32's own rounding).  bf16 operands are exact
// in bf16 `mma`, so a product of two bf16 tiles takes one m16n8k16 bf16 mma.
//
// Fragment layouts are PTX's `mma.sync.aligned.m16n8k8` (tf32) and
// `m16n8k16` (bf16), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, tf32):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, tf32):   b0 (t, g)  b1 (t+4, g)
//   C (16 x 8, f32):   c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   A (16 x 16, bf16): a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B (16 x 8, bf16):  b0 (2t..2t+1, g) b1 (2t+8..2t+9, g)
// (the lower k of a pair in the lower 16 bits).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 22 bits, both exact in tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

template <int K>
__device__ __forceinline__ void split(const float (&x)[K], uint32_t (&hi)[K], uint32_t (&lo)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void tf32_mma(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  tf32_mma(d, al, bh);
  tf32_mma(d, ah, bl);
  tf32_mma(d, ah, bh);
}

__device__ __forceinline__ void bf16_mma(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values as one operand word, `lo` in the lower 16 bits
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // p is 4-byte aligned
}

// acc[nt] += A . B over k in [0, 8 * ksteps), 3xTF32, with A (16 rows) and B
// (8 * NT columns) read from shared memory through strides:
//   A(r, k) = a[r * ar + k * ak] (times kscale[k] when kscale is given),
//   B(k, n) = b[k * bk + n * bn].
// The hi.hi products and the two small ones go to separate accumulators,
// summed at the end, so that consecutive mmas do not wait on one another.
template <int NT>
__device__ __forceinline__ void mma3_strided(float (&acc)[NT][4], const float* a, int ar, int ak,
                                             const float* b, int bk, int bn, int ksteps,
                                             int lane, const float* kscale = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  float small[NT][4] = {};
  for (int ks = 0; ks < ksteps; ++ks) {
    const float* ap = a + 8 * ks * ak;
    float av[4] = {ap[g * ar + t * ak], ap[(g + 8) * ar + t * ak],
                   ap[g * ar + (t + 4) * ak], ap[(g + 8) * ar + (t + 4) * ak]};
    if (kscale) {
      const float s0 = kscale[8 * ks + t], s1 = kscale[8 * ks + t + 4];
      av[0] *= s0;
      av[1] *= s0;
      av[2] *= s1;
      av[3] *= s1;
    }
    uint32_t ah[4], al[4];
    split(av, ah, al);
    const float* bp = b + 8 * ks * bk;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* bq = bp + 8 * nt * bn;
      const float bv[2] = {bq[t * bk + g * bn], bq[(t + 4) * bk + g * bn]};
      uint32_t bh[2], bl[2];
      split(bv, bh, bl);
      tf32_mma(small[nt], al, bh);
      tf32_mma(small[nt], ah, bl);
      tf32_mma(acc[nt], ah, bh);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += small[nt][e];
}

// acc[nt] += A . B^T over k in [0, 16 * ksteps), bf16: A (16 rows) and B
// (8 * NT rows) both row-major in k, row strides `as` and `bs` (even).
template <int NT>
__device__ __forceinline__ void bf16_rows(float (&acc)[NT][4], const __nv_bfloat16* a, int as,
                                          const __nv_bfloat16* b, int bs, int ksteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    const __nv_bfloat16* ap = a + 16 * ks + 2 * t;
    const uint32_t av[4] = {word(ap + g * as), word(ap + (g + 8) * as), word(ap + g * as + 8),
                            word(ap + (g + 8) * as + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* bp = b + (8 * nt + g) * bs + 16 * ks + 2 * t;
      const uint32_t bv[2] = {word(bp), word(bp + 8)};
      bf16_mma(acc[nt], av, bv);
    }
  }
}

// cp.async of BYTES (16: .cg, 4 or 8: .ca); a zero `valid` fills zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
