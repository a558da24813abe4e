// Fixed-lane SFP pack for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/sfp_pack.py:sfp_pack
// (_pack_kernel/_pack_body). Input: R rows of 128 bf16 or f32 values.
// Output: one 8- or 16-bit payload word per value
//   word = sign << (P-1) | dexp << (P-1-E) | man_top << (P-1-E-K)
// and one uint8 base per row = the max biased exponent of its 128 lanes
// (zeros included). Zero/subnormal inputs flush to (dexp_max, 0) with the
// sign cleared; values more than dexp_max binades below the base flush too.
//
// Bound on this card: memory. A bf16 value is read once (2 B) and leaves as
// a 1-byte word plus 1/128 of a base byte (~1.008 B). Design: one warp per
// 128-lane group, 4 consecutive values per lane, so each lane issues one
// 8-byte (bf16) or 16-byte (f32) load and one 4- or 8-byte store, and the
// group base is a single __reduce_max_sync over the lanes' exponent maxima.
// Integer arithmetic only, so the result is bit-for-bit the plain version's.
#include "sfp_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int SRC_BITS, int WORD_BITS>
__global__ void sfp_pack_kernel(const void* __restrict__ x,
                                void* __restrict__ payload,
                                uint8_t* __restrict__ bases, int rows,
                                SfpFields f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together

  constexpr int man_bits = SRC_BITS == 16 ? 7 : 23;
  uint32_t u[4];
  if (SRC_BITS == 16) {
    const uint2 w = reinterpret_cast<const uint2*>(x)[(size_t)row * 32 + lane];
    u[0] = w.x & 0xFFFFu; u[1] = w.x >> 16;
    u[2] = w.y & 0xFFFFu; u[3] = w.y >> 16;
  } else {
    const uint4 w = reinterpret_cast<const uint4*>(x)[(size_t)row * 32 + lane];
    u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
  }
  int e[4];
  unsigned emax = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[i] = (int)((u[i] >> man_bits) & 0xFFu);
    emax = max(emax, (unsigned)e[i]);
  }
  const int base = (int)__reduce_max_sync(0xffffffffu, emax);

  const int dmax = f.dexp_max();
  uint32_t word[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sign = (u[i] >> (SRC_BITS - 1)) & 1u;
    const uint32_t man = u[i] & ((1u << man_bits) - 1u);
    int dexp = base - e[i];
    uint32_t man_top = man >> (man_bits - f.man_keep);
    const bool flush = (e[i] == 0) || (dexp > dmax);
    if (flush) { dexp = dmax; man_top = 0u; }
    const uint32_t s = (e[i] == 0) ? 0u : sign;
    word[i] = (s << f.sign_shift()) | ((uint32_t)dexp << f.dexp_shift())
              | (man_top << f.man_shift());
  }
  if (WORD_BITS == 8) {
    const uint32_t packed = (word[0] & 0xFFu) | ((word[1] & 0xFFu) << 8)
                            | ((word[2] & 0xFFu) << 16) | ((word[3] & 0xFFu) << 24);
    reinterpret_cast<uint32_t*>(payload)[(size_t)row * 32 + lane] = packed;
  } else {
    uint2 packed;
    packed.x = (word[0] & 0xFFFFu) | ((word[1] & 0xFFFFu) << 16);
    packed.y = (word[2] & 0xFFFFu) | ((word[3] & 0xFFFFu) << 16);
    reinterpret_cast<uint2*>(payload)[(size_t)row * 32 + lane] = packed;
  }
  if (lane == 0) bases[row] = (uint8_t)base;
}

template <int SRC_BITS, int WORD_BITS>
void launch(const void* x, void* payload, uint8_t* bases, int rows,
            SfpFields f, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sfp_pack_kernel<SRC_BITS, WORD_BITS>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(x, payload, bases, rows, f);
}

}  // namespace

extern "C" int sfp_pack_launch(const void* x, void* payload, void* bases,
                               int rows, int src_bits, int man_keep,
                               int dexp_bits, int payload_bits, void* stream) {
  if (rows <= 0) return 0;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<uint8_t*>(bases);
  if (src_bits == 16 && payload_bits == 8) launch<16, 8>(x, payload, b, rows, f, s);
  else if (src_bits == 16 && payload_bits == 16) launch<16, 16>(x, payload, b, rows, f, s);
  else if (src_bits == 32 && payload_bits == 8) launch<32, 8>(x, payload, b, rows, f, s);
  else if (src_bits == 32 && payload_bits == 16) launch<32, 16>(x, payload, b, rows, f, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
