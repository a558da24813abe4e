// Shared device helpers of the SFP kernels: the fixed-lane word geometry,
// its encode (the ``_pack_words`` bit machine of kernels/ref.py, with the
// optional fused mantissa truncation Q(M, n)) and its decode
// (``_unpack_words``). Both pack kernels and every decoder call these, so
// the plain and fused packs cannot drift apart.
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

// Mask of the mantissa bits Q(M, n) keeps: the top n of man_bits, with n
// clamped to [0, man_bits] (containers._mantissa_keep_mask).
__device__ __forceinline__ uint32_t sfp_keep_mask(int n, int man_bits) {
  n = n < 0 ? 0 : (n > man_bits ? man_bits : n);
  const uint32_t man_mask = (1u << man_bits) - 1u;
  return man_mask ^ ((1u << (man_bits - n)) - 1u);
}

// Encode one value (raw bits u of a bf16 or f32 container with man_bits
// mantissa bits) against its group base into a payload word. man_keep_mask
// is all ones for the plain pack and sfp_keep_mask(n) for the fused one.
// Zero/subnormal inputs flush to (dexp_max, 0) with the sign cleared;
// values more than dexp_max binades below the base flush too.
__device__ __forceinline__ uint32_t sfp_encode_word(uint32_t u, int e, int base,
                                                    int src_bits, int man_bits,
                                                    uint32_t man_keep_mask,
                                                    const SfpFields f) {
  const uint32_t sign = (u >> (src_bits - 1)) & 1u;
  const uint32_t man = u & ((1u << man_bits) - 1u) & man_keep_mask;
  const int dmax = f.dexp_max();
  int dexp = base - e;
  uint32_t man_top = man >> (man_bits - f.man_keep);
  if (e == 0 || dexp > dmax) { dexp = dmax; man_top = 0u; }
  const uint32_t s = (e == 0) ? 0u : sign;
  return (s << f.sign_shift()) | ((uint32_t)dexp << f.dexp_shift())
         | (man_top << f.man_shift());
}

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
