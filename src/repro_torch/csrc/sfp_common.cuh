// Shared device helpers of the SFP kernels: the fixed-lane word geometry
// and its decode (the ``_unpack_words`` bit machine of kernels/ref.py).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SFP_NEG_INF (-1e30f)
#define SFP_GROUP 128

struct SfpFields {
  int man_keep;      // mantissa bits kept in the payload word
  int dexp_bits;     // delta-exponent field width
  int payload_bits;  // word width (8 or 16)

  __host__ __device__ int sign_shift() const { return payload_bits - 1; }
  __host__ __device__ int dexp_shift() const { return payload_bits - 1 - dexp_bits; }
  __host__ __device__ int man_shift() const {
    return payload_bits - 1 - dexp_bits - man_keep;
  }
  __host__ __device__ int dexp_max() const { return (1 << dexp_bits) - 1; }
};

// Decode one payload word against its group base into the f32 value of
// the bf16 or f32 container it was packed from (both have an 8-bit
// exponent, and a bf16 is the top half of an f32, so the f32 rebuild is
// exact for either). (dexp_max, man 0) is the flush code and decodes to
// +0; the rebuilt exponent clamps at 0.
__device__ __forceinline__ float sfp_decode_word(uint32_t p, int base,
                                                 const SfpFields f) {
  const uint32_t sign = (p >> f.sign_shift()) & 1u;
  const int dexp = (int)((p >> f.dexp_shift()) & (uint32_t)f.dexp_max());
  const uint32_t man_top = (p >> f.man_shift()) & ((1u << f.man_keep) - 1u);
  if (dexp == f.dexp_max() && man_top == 0u) return 0.0f;
  int e = base - dexp;
  e = e < 0 ? 0 : e;
  const uint32_t man32 = man_top << (23 - f.man_keep);
  const uint32_t bits = (sign << 31) | ((uint32_t)e << 23) | man32;
  return __uint_as_float(bits);
}
