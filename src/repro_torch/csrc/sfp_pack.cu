// Fixed-lane SFP pack, fused quantize+pack and unpack for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/sfp_pack.py:sfp_pack
// (_pack_kernel), sfp_quantize_pack (_quantize_pack_kernel) and sfp_unpack
// (_unpack_kernel). Input of the packs: R rows of 128 bf16 or f32 values.
// Output: one 8- or 16-bit payload word per value
//   word = sign << (P-1) | dexp << (P-1-E) | man_top << (P-1-E-K)
// and one uint8 base per row = the max biased exponent of its 128 lanes
// (zeros included). Zero/subnormal inputs flush to (dexp_max, 0) with the
// sign cleared; values more than dexp_max binades below the base flush too.
// The fused pack first keeps only the top n mantissa bits (Q(M, n), n read
// from device memory so a step-varying bitlength needs no host sync); the
// plain pack is the same kernel with no n. The unpack is the inverse bit
// machine (sfp_decode_word) into bf16 or f32.
//
// Bound on this card: memory. A bf16 value is read once (2 B) and leaves as
// a 1-byte word plus 1/128 of a base byte (~1.008 B), and the unpack moves
// the same bytes the other way. Design: one warp per 128-lane group, 4
// consecutive values per lane, so each lane issues one 8-byte (bf16) or
// 16-byte (f32) access and one 4- or 8-byte payload access, and the group
// base is a single __reduce_max_sync over the lanes' exponent maxima.
// Integer arithmetic only, so the results are bit-for-bit the plain
// versions'.
#include "sfp_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int SRC_BITS, int WORD_BITS>
__global__ void sfp_pack_kernel(const void* __restrict__ x,
                                void* __restrict__ payload,
                                uint8_t* __restrict__ bases, int rows,
                                const int* __restrict__ n_ptr, SfpFields f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together

  constexpr int man_bits = SRC_BITS == 16 ? 7 : 23;
  const uint32_t keep = n_ptr == nullptr ? 0xFFFFFFFFu
                                         : sfp_keep_mask(*n_ptr, man_bits);
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

  uint32_t word[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    word[i] = sfp_encode_word(u[i], e[i], base, SRC_BITS, man_bits, keep, f);
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

template <int DST_BITS, int WORD_BITS>
__global__ void sfp_unpack_kernel(const void* __restrict__ payload,
                                  const uint8_t* __restrict__ bases,
                                  void* __restrict__ out, int rows,
                                  SfpFields f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int base = bases[row];
  uint32_t p[4];
  if (WORD_BITS == 8) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(payload)[(size_t)row * 32 + lane];
    p[0] = w & 0xFFu; p[1] = (w >> 8) & 0xFFu;
    p[2] = (w >> 16) & 0xFFu; p[3] = w >> 24;
  } else {
    const uint2 w = reinterpret_cast<const uint2*>(payload)[(size_t)row * 32 + lane];
    p[0] = w.x & 0xFFFFu; p[1] = w.x >> 16;
    p[2] = w.y & 0xFFFFu; p[3] = w.y >> 16;
  }
  uint32_t bits[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bits[i] = __float_as_uint(sfp_decode_word(p[i], base, f));
  if (DST_BITS == 32) {
    reinterpret_cast<uint4*>(out)[(size_t)row * 32 + lane] =
        make_uint4(bits[0], bits[1], bits[2], bits[3]);
  } else {  // a bf16 is the top half of the exact f32 rebuild
    uint2 o;
    o.x = (bits[0] >> 16) | (bits[1] & 0xFFFF0000u);
    o.y = (bits[2] >> 16) | (bits[3] & 0xFFFF0000u);
    reinterpret_cast<uint2*>(out)[(size_t)row * 32 + lane] = o;
  }
}

template <int SRC_BITS, int WORD_BITS>
void launch_pack(const void* x, void* payload, uint8_t* bases, int rows,
                 const int* n_ptr, SfpFields f, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sfp_pack_kernel<SRC_BITS, WORD_BITS>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(x, payload, bases, rows,
                                                   n_ptr, f);
}

template <int DST_BITS, int WORD_BITS>
void launch_unpack(const void* payload, const uint8_t* bases, void* out,
                   int rows, SfpFields f, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sfp_unpack_kernel<DST_BITS, WORD_BITS>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(payload, bases, out, rows,
                                                   f);
}

int pack(const void* x, void* payload, void* bases, int rows, int src_bits,
         const int* n_ptr, int man_keep, int dexp_bits, int payload_bits,
         void* stream) {
  if (rows <= 0) return 0;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<uint8_t*>(bases);
  if (src_bits == 16 && payload_bits == 8) launch_pack<16, 8>(x, payload, b, rows, n_ptr, f, s);
  else if (src_bits == 16 && payload_bits == 16) launch_pack<16, 16>(x, payload, b, rows, n_ptr, f, s);
  else if (src_bits == 32 && payload_bits == 8) launch_pack<32, 8>(x, payload, b, rows, n_ptr, f, s);
  else if (src_bits == 32 && payload_bits == 16) launch_pack<32, 16>(x, payload, b, rows, n_ptr, f, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfp_pack_launch(const void* x, void* payload, void* bases,
                               int rows, int src_bits, int man_keep,
                               int dexp_bits, int payload_bits, void* stream) {
  return pack(x, payload, bases, rows, src_bits, nullptr, man_keep, dexp_bits,
              payload_bits, stream);
}

extern "C" int sfp_quantize_pack_launch(const void* x, const void* n,
                                        void* payload, void* bases, int rows,
                                        int src_bits, int man_keep,
                                        int dexp_bits, int payload_bits,
                                        void* stream) {
  if (n == nullptr) return (int)cudaErrorInvalidValue;
  return pack(x, payload, bases, rows, src_bits, static_cast<const int*>(n),
              man_keep, dexp_bits, payload_bits, stream);
}

extern "C" int sfp_unpack_launch(const void* payload, const void* bases,
                                 void* out, int rows, int dst_bits,
                                 int man_keep, int dexp_bits,
                                 int payload_bits, void* stream) {
  if (rows <= 0) return 0;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bases);
  if (dst_bits == 16 && payload_bits == 8) launch_unpack<16, 8>(payload, b, out, rows, f, s);
  else if (dst_bits == 16 && payload_bits == 16) launch_unpack<16, 16>(payload, b, out, rows, f, s);
  else if (dst_bits == 32 && payload_bits == 8) launch_unpack<32, 8>(payload, b, out, rows, f, s);
  else if (dst_bits == 32 && payload_bits == 16) launch_unpack<32, 16>(payload, b, out, rows, f, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
