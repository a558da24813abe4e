// The SFP word encode and decode of two bf16 values a register (16-bit
// SIMD), and the row max over a half-warp, shared by the fixed-lane and
// the bit-plane kernels. A word here is P = 1 + E + K bits wide with no
// padding; the fixed-lane kernels shift it into their wider lanes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sfp_common.cuh"

// Constants of the pair encode and decode of one geometry: a 16-bit value
// repeated in both halves of each word.
struct PairFields {
  uint32_t emask2;   // exponent field after the shift: 0xFF << K
  uint32_t mkeep2;   // kept mantissa bits after the shift (of (1 << K) - 1)
  uint32_t magm2;    // word without its sign: (1 << (P - 1)) - 1
  uint32_t flush2;   // the flush magnitude: dexp_max << K
  uint32_t flush7;   // the same at a bf16's exponent: dexp_max << 7
  int man_shift;     // 7 - K: bf16 mantissa bits dropped
  int sign_shift;    // 16 - P: a half's bit 15 to its bit P - 1
};

__device__ __forceinline__ uint32_t twice(uint32_t v) { return v * 0x10001u; }

__device__ __forceinline__ PairFields pair_fields(const SfpFields f,
                                                  uint32_t keep) {
  const int K = f.man_keep, P = f.payload_bits;
  PairFields c;
  c.man_shift = 7 - K;
  c.sign_shift = 16 - P;
  c.emask2 = twice(0xFFu << K);
  c.mkeep2 = twice((keep & 0x7Fu) >> (7 - K));
  c.magm2 = twice((1u << (P - 1)) - 1u);
  c.flush2 = twice((uint32_t)f.dexp_max() << K);
  c.flush7 = twice((uint32_t)f.dexp_max() << 7);
  return c;
}

// Encode the two bf16 values in the halves of u2 (y2 = u2 >> (7 - K): a
// half's exponent e at bits K..K+7 and its top K mantissa bits below; ek2
// = e << K in each half) against the row base: the payload words of
// sfp_encode_word in the halves of the result. A value flushes when e <
// lo = max(1, base - dexp_max) (zero or subnormal, or more than dexp_max
// binades below the base): ok2 has bit 15 of a half set when it does not
// (ek + 0x8000 - (lo << K) stays inside the half, since e << K < 2^15).
// The sign survives unless e == 0.
__device__ __forceinline__ uint32_t encode_pair(uint32_t u2, uint32_t y2,
                                                uint32_t ek2, uint32_t c2,
                                                uint32_t baseK2,
                                                const PairFields& c) {
  const uint32_t ok2 = (ek2 + c2) & 0x80008000u;
  const uint32_t okm = ok2 - (ok2 >> 15);          // 0x7FFF where kept
  const uint32_t mag = (baseK2 - ek2) | (y2 & c.mkeep2);
  const uint32_t nz2 = (ek2 + 0x7FFF7FFFu) & 0x80008000u;   // e != 0
  const uint32_t sgn = (u2 & nz2) >> c.sign_shift;
  return sgn | (mag & okm) | (c.flush2 & ~okm);
}

// Decode the two payload words in the halves of p2 against the row base
// (base2: (base + 256) << 7 in each half) into two bf16 values: the bits
// of sfp_decode_word. s holds a word's dexp and mantissa where a bf16
// keeps its exponent and mantissa. The flush code (dexp_max, man 0) gives
// +0 whatever its sign; the rebuilt exponent base - dexp clamps at 0 (t2 =
// (256 + base - dexp) << 7 has bit 15 set when it is not negative).
__device__ __forceinline__ uint32_t decode_pair(uint32_t p2, uint32_t base2,
                                                const PairFields& c) {
  const uint32_t s = (p2 & c.magm2) << c.man_shift;
  const uint32_t nz = ((s ^ c.flush7) + 0x7FFF7FFFu) & 0x80008000u;
  const uint32_t t2 = base2 - (s & 0x7F807F80u);
  const uint32_t m = t2 & nz;
  const uint32_t e = t2 & (m - (m >> 8));          // 0x7F80 where kept
  return ((p2 << c.sign_shift) & nz) | e | (s & 0x007F007Fu);
}

// The max over the 16 threads of a row (a half-warp).
__device__ __forceinline__ int half_warp_max(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
