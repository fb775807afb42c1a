// float32 products on the TF32 tensor cores with the 3 x TF32 split
// (sm_90a), shared by the fused decode's forward (fused_decode.cu, K1/K3)
// and backward (fused_decode_bwd.cu, K2).
//
// Each float32 operand x = hi + lo, hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: 10 mantissa bits, to nearest, ties away from zero); a product
// a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi, which keeps float32
// accuracy where one TF32 pass keeps about three decimal digits
// (tests/test_torch_tf32_split.py emulates both on the CPU).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// round to TF32 (10 mantissa bits), to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the columns j < n_cols of the (C, j_pad) float32 matrix A (columns
// >= n_out read as 0) into shared memory, split, in the mma's B-fragment
// order: (n_cols / 8) x (C / 8) blocks of 32 uint4; lane 4 g + t of block
// (nt, ks) holds (hi, hi, lo, lo) of A[8 ks + t][8 nt + g] and
// A[8 ks + t + 4][8 nt + g]. Each of the block's THREADS threads fills
// whole 16-byte slots (conflict-free stores) with 16 loads of A in flight.
// No barrier: the caller synchronises before reading.
template <int C, int THREADS>
__device__ __forceinline__ void stage_split_a(uint32_t* sB, const float* __restrict__ A,
                                              int j_pad, int n_out, int n_cols) {
  constexpr int kKSteps = C / 8;
  const int n_slots = (n_cols / 8) * kKSteps * 32;
  uint4* sB4 = reinterpret_cast<uint4*>(sB);
  for (int s0 = threadIdx.x; s0 < n_slots; s0 += 8 * THREADS) {
    float a[8][2];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int slot = s0 + b * THREADS, blk = slot >> 5, ln = slot & 31;
      const int k = 8 * (blk % kKSteps) + (ln & 3), j = 8 * (blk / kKSteps) + (ln >> 2);
      const bool live = slot < n_slots && j < n_out;
      a[b][0] = live ? __ldg(A + k * j_pad + j) : 0.f;
      a[b][1] = live ? __ldg(A + (k + 4) * j_pad + j) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int slot = s0 + b * THREADS;
      if (slot >= n_slots) break;
      uint4 v;
      split(a[b][0], v.x, v.z);
      split(a[b][1], v.y, v.w);
      sB4[slot] = v;
    }
  }
}

}  // namespace tf32x3
