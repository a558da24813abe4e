// Register bit-matrix transposes (SWAR) and 16-byte asynchronous copies
// into shared memory, shared by the decode and Gecko kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// 16-byte asynchronous copy; bytes past src_bytes are filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Hacker's Delight delta swap: the bits of b under mask >> sh trade
// places with the bits of a under mask.
__device__ __forceinline__ void delta_swap(uint32_t& a, uint32_t& b, int sh,
                                           uint32_t mask) {
  const uint32_t t = (a ^ (b << sh)) & mask;
  a ^= t;
  b ^= t >> sh;
}

// SWAR 8x8 bit-matrix transpose of 4 byte-matrices side by side: on entry
// byte i of x[p] is row p of matrix i, on exit byte i of x[j] is its
// column j (ref._reg_transpose8 of the JAX package).
__device__ __forceinline__ void transpose8(uint32_t x[8]) {
  delta_swap(x[0], x[1], 1, 0xAAAAAAAAu);
  delta_swap(x[2], x[3], 1, 0xAAAAAAAAu);
  delta_swap(x[4], x[5], 1, 0xAAAAAAAAu);
  delta_swap(x[6], x[7], 1, 0xAAAAAAAAu);
  delta_swap(x[0], x[2], 2, 0xCCCCCCCCu);
  delta_swap(x[1], x[3], 2, 0xCCCCCCCCu);
  delta_swap(x[4], x[6], 2, 0xCCCCCCCCu);
  delta_swap(x[5], x[7], 2, 0xCCCCCCCCu);
  delta_swap(x[0], x[4], 4, 0xF0F0F0F0u);
  delta_swap(x[1], x[5], 4, 0xF0F0F0F0u);
  delta_swap(x[2], x[6], 4, 0xF0F0F0F0u);
  delta_swap(x[3], x[7], 4, 0xF0F0F0F0u);
}

// Delta swap inside one word: bit p under mask trades places with bit
// p + sh.
__device__ __forceinline__ uint32_t delta_swap1(uint32_t x, int sh,
                                                uint32_t mask) {
  const uint32_t t = (x ^ (x >> sh)) & mask;
  return x ^ t ^ (t << sh);
}

// Transpose of one 8x8 bit matrix held as 8 bytes, rows 0-3 in lo and
// 4-7 in hi (bit c of byte r is entry (r, c)): 2x2 blocks, then 4x4
// blocks, then the 4x4 quadrants. It is its own inverse.
__device__ __forceinline__ void transpose8x8(uint32_t& lo, uint32_t& hi) {
  lo = delta_swap1(lo, 7, 0x00AA00AAu);
  hi = delta_swap1(hi, 7, 0x00AA00AAu);
  lo = delta_swap1(lo, 14, 0x0000CCCCu);
  hi = delta_swap1(hi, 14, 0x0000CCCCu);
  delta_swap(lo, hi, 4, 0xF0F0F0F0u);
}
