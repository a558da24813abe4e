// Dense bit-plane SFP pack, fused quantize+pack and unpack for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/bitplane_pack.py:
// bitplane_pack (_bitplane_pack_kernel), bitplane_quantize_pack
// (_bitplane_quantize_pack_kernel) and bitplane_unpack
// (_bitplane_unpack_kernel). Input of the packs: R rows of 128 bf16 or
// f32 values. Each value becomes the same payload word as in sfp_pack.cu
// (sfp_encode_word of sfp_common.cuh, with the optional fused Q(M, n), n
// read from device memory), P = 1 + E + K bits wide (3..16), and the words
// of a row are stored as P byte-aligned bit planes: plane p is 16 bytes,
// byte i holds bit p of lanes 8i..8i+7 (bit j <-> lane 8i+j), planes LSB
// first, so a row is P * 16 bytes. One uint8 base per row (max biased
// exponent). The unpack is the inverse into bf16 or f32
// (sfp_decode_word).
//
// Bound on this card: memory. A bf16 value is read once (2 B) and leaves
// as P/8 bytes plus 1/128 of a base byte; the unpack moves the same bytes
// the other way. Design, simple first: one warp per 128-lane group; lane t
// holds lanes t, 32+t, 64+t and 96+t, so each of its 4 loads is one
// coalesced 64/128-byte warp access. The base is a __reduce_max_sync; the
// little-endian uint32 k of plane p is __ballot_sync of bit p of the words
// of lanes 32k..32k+31 (bit t of that uint32 is lane 32k+t, which is the
// byte layout above). The P*4 plane words of a row are written by lanes
// 0..P*4-1 (two rounds when P*4 > 32). The unpack reads them back the same
// way and lane t takes bit t of each plane word by a warp shuffle. Integer
// arithmetic only, so the results are bit-for-bit the plain versions'.
#include "sfp_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPlanes = 16;

template <int SRC_BITS>
__global__ void bitplane_pack_kernel(const void* __restrict__ x,
                                     uint32_t* __restrict__ planes,
                                     uint8_t* __restrict__ bases, int rows,
                                     const int* __restrict__ n_ptr,
                                     SfpFields f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together

  constexpr int man_bits = SRC_BITS == 16 ? 7 : 23;
  const uint32_t keep = n_ptr == nullptr ? 0xFFFFFFFFu
                                         : sfp_keep_mask(*n_ptr, man_bits);
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t idx = (size_t)row * SFP_GROUP + 32 * i + lane;
    u[i] = SRC_BITS == 16 ? (uint32_t) reinterpret_cast<const uint16_t*>(x)[idx]
                          : reinterpret_cast<const uint32_t*>(x)[idx];
  }
  int e[4];
  unsigned emax = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[i] = (int)((u[i] >> man_bits) & 0xFFu);
    emax = max(emax, (unsigned)e[i]);
  }
  const int base = (int)__reduce_max_sync(0xffffffffu, emax);

  uint32_t word[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    word[i] = sfp_encode_word(u[i], e[i], base, SRC_BITS, man_bits, keep, f);

  // Plane word j = 4p + k of the row: lane j keeps it (j < 32), lane j-32
  // keeps it in its second register (j >= 32).
  const int P = f.payload_bits;
  uint32_t mine = 0u, mine2 = 0u;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    if (p >= P) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = __ballot_sync(0xffffffffu, (word[k] >> p) & 1u);
      const int j = 4 * p + k;
      if (j < 32) { if (lane == j) mine = b; }
      else if (lane == j - 32) mine2 = b;
    }
  }
  uint32_t* out = planes + (size_t)row * P * 4;
  if (lane < 4 * P) out[lane] = mine;
  if (lane + 32 < 4 * P) out[lane + 32] = mine2;
  if (lane == 0) bases[row] = (uint8_t)base;
}

template <int DST_BITS>
__global__ void bitplane_unpack_kernel(const uint32_t* __restrict__ planes,
                                       const uint8_t* __restrict__ bases,
                                       void* __restrict__ out, int rows,
                                       SfpFields f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int P = f.payload_bits;
  const uint32_t* in = planes + (size_t)row * P * 4;
  const uint32_t mine = lane < 4 * P ? in[lane] : 0u;
  const uint32_t mine2 = lane + 32 < 4 * P ? in[lane + 32] : 0u;
  const int base = bases[row];

  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    if (p >= P) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * p + k;  // uniform across the warp
      const uint32_t b = __shfl_sync(0xffffffffu, j < 32 ? mine : mine2,
                                     j & 31);
      word[k] |= ((b >> lane) & 1u) << p;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t bits = __float_as_uint(sfp_decode_word(word[i], base, f));
    const size_t idx = (size_t)row * SFP_GROUP + 32 * i + lane;
    if (DST_BITS == 32) reinterpret_cast<uint32_t*>(out)[idx] = bits;
    else  // a bf16 is the top half of the exact f32 rebuild
      reinterpret_cast<uint16_t*>(out)[idx] = (uint16_t)(bits >> 16);
  }
}

bool fields_ok(int man_keep, int dexp_bits, int payload_bits) {
  return payload_bits >= 3 && payload_bits <= kMaxPlanes && man_keep >= 1
         && dexp_bits >= 1 && 1 + dexp_bits + man_keep == payload_bits;
}

int pack(const void* x, void* planes, void* bases, int rows, int src_bits,
         const int* n_ptr, int man_keep, int dexp_bits, int payload_bits,
         void* stream) {
  if (rows <= 0) return 0;
  if (!fields_ok(man_keep, dexp_bits, payload_bits))
    return (int)cudaErrorInvalidValue;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<uint32_t*>(planes);
  auto b = static_cast<uint8_t*>(bases);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (src_bits == 16)
    bitplane_pack_kernel<16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        x, p, b, rows, n_ptr, f);
  else if (src_bits == 32)
    bitplane_pack_kernel<32><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        x, p, b, rows, n_ptr, f);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bitplane_pack_launch(const void* x, void* planes, void* bases,
                                    int rows, int src_bits, int man_keep,
                                    int dexp_bits, int payload_bits,
                                    void* stream) {
  return pack(x, planes, bases, rows, src_bits, nullptr, man_keep, dexp_bits,
              payload_bits, stream);
}

extern "C" int bitplane_quantize_pack_launch(const void* x, const void* n,
                                             void* planes, void* bases,
                                             int rows, int src_bits,
                                             int man_keep, int dexp_bits,
                                             int payload_bits, void* stream) {
  if (n == nullptr) return (int)cudaErrorInvalidValue;
  return pack(x, planes, bases, rows, src_bits, static_cast<const int*>(n),
              man_keep, dexp_bits, payload_bits, stream);
}

extern "C" int bitplane_unpack_launch(const void* planes, const void* bases,
                                      void* out, int rows, int dst_bits,
                                      int man_keep, int dexp_bits,
                                      int payload_bits, void* stream) {
  if (rows <= 0) return 0;
  if (!fields_ok(man_keep, dexp_bits, payload_bits))
    return (int)cudaErrorInvalidValue;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(planes);
  auto b = static_cast<const uint8_t*>(bases);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (dst_bits == 16)
    bitplane_unpack_kernel<16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        p, b, out, rows, f);
  else if (dst_bits == 32)
    bitplane_unpack_kernel<32><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        p, b, out, rows, f);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
