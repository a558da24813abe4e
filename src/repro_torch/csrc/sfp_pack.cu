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
// plain pack is the same kernel with no n. The unpack is the inverse into
// bf16 or f32. The plain versions are sfp_pack_rows / sfp_unpack_rows in
// kernels/ref.py; sfp_{pack,unpack}_swar there mirror the arithmetic below
// step for step.
//
// Bound on this card: bytes. A bf16 value is read once (2 B) and leaves as
// a 1-byte word plus 1/128 of a base byte (~1.008 B); the unpack moves the
// same bytes the other way. At the stash shape (9.4 M values) that is ~8.5
// us at 3.35 TB/s, and every 10 integer operations a value cost ~6 us at
// 64 a clock an SM, so the design keeps both the bytes in flight and the
// operations a value low (the layout of csrc/bitplane_pack.cu without its
// plane transposes):
// 1. A thread per 8 lanes. 16 threads make a row (a half-warp), a block of
//    256 threads 16 rows a pass. A bf16 thread reads its 8 values with one
//    16-byte load (f32: two). Up to the rows an H100 holds at once with one
//    pass (8 blocks on each of 132 SMs), a tile is one pass, so a one-token
//    pack of 36 rows is one load a thread; above, a tile is two passes,
//    both loads in flight before any arithmetic.
// 2. Two bf16 values a register (encode_pair, decode_pair; sfp_pair.cuh),
//    ~8 operations a value against sfp_encode_word's ~14 and
//    sfp_decode_word's ~16. They work on the word's payload width P' = 1 +
//    E + K. A fixed-lane word may carry man_shift = P - P' padding bits
//    below its mantissa (3 for sfp16 on bf16), so the pack shifts each pair
//    left by man_shift and the unpack right, before decode_pair, whose
//    masks drop the padding that slides into the low half. The pair
//    decode holds E <= 8 delta bits, so bf16 words with a wider delta
//    field (sfp16-m3e10, sfp16-m1e14) take sfp_encode_word /
//    sfp_decode_word, one value a register, as f32 does.
// 3. The row base is a max over the half-warp: 4 __shfl_xor_sync.
// 4. One access a thread and row each way. A thread's 8 words are its
//    4 pair registers (sfp16: one 16-byte store or load) or their low bytes
//    (sfp8: two __byte_perm, one 8-byte store or load), the 16 threads of a
//    row cover it in order, so a warp moves 512 or 256 contiguous bytes.
//    The first thread of a row stores its base byte; the unpack's threads
//    read their row's base byte, one broadcast a half-warp. No shared
//    memory and no barrier.
// Tried on the H100 and dropped (PERF.md): the tile's bases staged
// in shared memory and stored 16 to a store (as in csrc/bitplane_pack.cu)
// tied at the large shapes but cost the one-token pack ~0.15 us, the
// barrier and a dependent store; sfp8 words staged for 16-byte stores tied
// with the direct 8-byte ones; two passes at one token, one pass at the
// stash shape and four passes above the threshold were slower; a
// half-warp __reduce_max_sync in place of the 4 shuffles gained nothing.
// Integer arithmetic only, so the results are bit-for-bit the plain
// versions'.
#include "sfp_common.cuh"
#include "sfp_pair.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 16;                    // 8 lanes a thread
constexpr int kRowsPerPass = kThreads / kRowThreads;
// Rows an H100 holds at once with one pass: 8 blocks on each of 132 SMs.
constexpr int kOnePassRows = 8 * 132 * kRowsPerPass;

// The pair geometry of a fixed-lane word: its fields without the padding.
__device__ __forceinline__ SfpFields unpadded(const SfpFields f) {
  return SfpFields{f.man_keep, f.dexp_bits, 1 + f.dexp_bits + f.man_keep};
}

template <int SRC_BITS, int WORD_BITS, int U, bool PAIR>
__global__ void __launch_bounds__(kThreads)
sfp_pack_kernel(const uint4* __restrict__ x, void* __restrict__ payload,
                uint8_t* __restrict__ bases, int rows,
                const int* __restrict__ n_ptr, SfpFields f) {
  constexpr int kTile = kRowsPerPass * U;          // U passes a tile
  constexpr int kLoads = SRC_BITS / 16;            // 16-byte loads a row
  constexpr int man_bits = SRC_BITS == 16 ? 7 : 23;
  const int t = threadIdx.x % kRowThreads, q = threadIdx.x / kRowThreads;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int n_rows = (int)min((long long)kTile, rows - row0);

  uint4 v[U][kLoads];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
      v[u][l] = r < n_rows
          ? __ldg(x + (row0 + r) * (16 * kLoads) + kLoads * t + l)
          : make_uint4(0u, 0u, 0u, 0u);
  }
  const uint32_t keep = n_ptr == nullptr ? 0xFFFFFFFFu
                                         : sfp_keep_mask(*n_ptr, man_bits);
  const int dmax = f.dexp_max(), pad = f.man_shift();
  PairFields c{};
  if constexpr (PAIR) c = pair_fields(unpadded(f), keep & 0x7Fu);

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;            // the half-warp's row
    uint32_t w[4];                                 // words 2k, 2k + 1
    int base;
    if constexpr (PAIR) {
      const int K = f.man_keep;
      const uint32_t u2[4] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w};
      uint32_t y2[4], ek2[4], mh = 0u, ml = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        y2[k] = u2[k] >> c.man_shift;
        ek2[k] = y2[k] & c.emask2;
        mh = max(mh, ek2[k]);                      // high halves decide
        ml = max(ml, ek2[k] << 16);                // the low halves alone
      }
      const int baseK = half_warp_max((int)(max(mh, ml) >> 16));
      base = baseK >> K;
      const int lo = max(1, base - dmax);
      const uint32_t c2 = twice(0x8000u - ((uint32_t)lo << K));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = encode_pair(u2[k], y2[k], ek2[k], c2, twice(baseK), c) << pad;
    } else if constexpr (SRC_BITS == 16) {
      // A delta field wider than 8 bits: one value a register.
      const uint32_t u2[4] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w};
      uint32_t uu[8];
      int e[8], emax = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uu[j] = (u2[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
        e[j] = (int)((uu[j] >> 7) & 0xFFu);
        emax = max(emax, e[j]);
      }
      base = half_warp_max(emax);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = sfp_encode_word(uu[2 * k], e[2 * k], base, 16, 7, keep, f)
               | (sfp_encode_word(uu[2 * k + 1], e[2 * k + 1], base, 16, 7,
                                  keep, f) << 16);
    } else {
      const uint32_t uu[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                              v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
      int e[8], emax = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = (int)((uu[j] >> 23) & 0xFFu);
        emax = max(emax, e[j]);
      }
      base = half_warp_max(emax);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = sfp_encode_word(uu[2 * k], e[2 * k], base, 32, 23, keep, f)
               | (sfp_encode_word(uu[2 * k + 1], e[2 * k + 1], base, 32, 23,
                                  keep, f) << 16);
    }
    if (r < n_rows) {
      const long long i = (row0 + r) * kRowThreads + t;   // the thread's chunk
      if constexpr (WORD_BITS == 16) {
        reinterpret_cast<uint4*>(payload)[i] = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
      } else {
        reinterpret_cast<uint2*>(payload)[i] = make_uint2(
            __byte_perm(w[0], w[1], 0x6420), __byte_perm(w[2], w[3], 0x6420));
      }
      if (t == 0) bases[row0 + r] = (uint8_t)base;
    }
  }
}

template <int DST_BITS, int WORD_BITS, int U, bool PAIR>
__global__ void __launch_bounds__(kThreads)
sfp_unpack_kernel(const void* __restrict__ payload,
                  const uint8_t* __restrict__ bases, uint4* __restrict__ out,
                  int rows, SfpFields f) {
  constexpr int kStores = DST_BITS / 16;           // 16-byte stores a row
  const int t = threadIdx.x % kRowThreads, q = threadIdx.x / kRowThreads;
  const long long row0 = (long long)blockIdx.x * kRowsPerPass * U;
  const int n_rows = (int)min((long long)kRowsPerPass * U, rows - row0);

  uint4 p[U];                                      // sfp8: .x and .y
  int base[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;
    const long long i = (row0 + r) * kRowThreads + t;     // the thread's chunk
    p[u] = make_uint4(0u, 0u, 0u, 0u);
    base[u] = 0;
    if (r < n_rows) {
      if constexpr (WORD_BITS == 16) {
        p[u] = __ldg(reinterpret_cast<const uint4*>(payload) + i);
      } else {
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(payload) + i);
        p[u].x = b.x;
        p[u].y = b.y;
      }
      base[u] = (int)__ldg(bases + row0 + r);
    }
  }
  const int pad = f.man_shift();
  PairFields c{};
  if constexpr (PAIR) c = pair_fields(unpadded(f), 0x7Fu);

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;
    if (r >= n_rows) break;
    uint32_t w[4];                                 // words 2k, 2k + 1
    if constexpr (WORD_BITS == 16) {
      w[0] = p[u].x; w[1] = p[u].y; w[2] = p[u].z; w[3] = p[u].w;
    } else {
      w[0] = __byte_perm(p[u].x, 0u, 0x4140);
      w[1] = __byte_perm(p[u].x, 0u, 0x4342);
      w[2] = __byte_perm(p[u].y, 0u, 0x4140);
      w[3] = __byte_perm(p[u].y, 0u, 0x4342);
    }
    uint4* o = out + (row0 + r) * (16 * kStores) + kStores * t;
    if constexpr (PAIR) {
      // The high word's padding lands in the low half's bits P'..15,
      // which decode_pair masks off.
      const uint32_t b2 = twice(((uint32_t)base[u] + 256u) << 7);
      *o = make_uint4(decode_pair(w[0] >> pad, b2, c),
                      decode_pair(w[1] >> pad, b2, c),
                      decode_pair(w[2] >> pad, b2, c),
                      decode_pair(w[3] >> pad, b2, c));
    } else if constexpr (DST_BITS == 16) {
      // A delta field wider than 8 bits: one value a register; a bf16 is
      // the top half of the f32 the decode rebuilds, exactly.
      uint32_t bits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bits[k] = (__float_as_uint(sfp_decode_word(w[k] & 0xFFFFu, base[u],
                                                   f)) >> 16)
                  | (__float_as_uint(sfp_decode_word(w[k] >> 16, base[u], f))
                     & 0xFFFF0000u);
      *o = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    } else {
      uint32_t bits[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bits[j] = __float_as_uint(sfp_decode_word(
            (w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu, base[u], f));
      o[0] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
      o[1] = make_uint4(bits[4], bits[5], bits[6], bits[7]);
    }
  }
}

// Words of 8 or 16 bits that hold their fields (K <= 7 mantissa bits from
// a bf16).
bool fields_ok(int float_bits, int man_keep, int dexp_bits,
               int payload_bits) {
  return (float_bits == 16 || float_bits == 32)
         && (payload_bits == 8 || payload_bits == 16) && man_keep >= 0
         && dexp_bits >= 1 && 1 + dexp_bits + man_keep <= payload_bits
         && man_keep <= (float_bits == 16 ? 7 : 23);
}

// bf16 words take the pair code, whose decode holds E <= 8 delta bits;
// wider deltas (sfp16-m3e10, sfp16-m1e14) and f32 one value a register.
bool pair_route(int float_bits, int dexp_bits) {
  return float_bits == 16 && dexp_bits <= 8;
}

template <int SRC_BITS, int WORD_BITS, bool PAIR>
void launch_pack(const uint4* x, void* payload, uint8_t* bases, int rows,
                 const int* n_ptr, SfpFields f, cudaStream_t s) {
  if (rows <= kOnePassRows) {
    const int grid = (rows + kRowsPerPass - 1) / kRowsPerPass;
    sfp_pack_kernel<SRC_BITS, WORD_BITS, 1, PAIR><<<grid, kThreads, 0, s>>>(
        x, payload, bases, rows, n_ptr, f);
  } else {
    const int grid = (rows + 2 * kRowsPerPass - 1) / (2 * kRowsPerPass);
    sfp_pack_kernel<SRC_BITS, WORD_BITS, 2, PAIR><<<grid, kThreads, 0, s>>>(
        x, payload, bases, rows, n_ptr, f);
  }
}

template <int DST_BITS, int WORD_BITS, bool PAIR>
void launch_unpack(const void* payload, const uint8_t* bases, uint4* out,
                   int rows, SfpFields f, cudaStream_t s) {
  if (rows <= kOnePassRows) {
    const int grid = (rows + kRowsPerPass - 1) / kRowsPerPass;
    sfp_unpack_kernel<DST_BITS, WORD_BITS, 1, PAIR>
        <<<grid, kThreads, 0, s>>>(payload, bases, out, rows, f);
  } else {
    const int grid = (rows + 2 * kRowsPerPass - 1) / (2 * kRowsPerPass);
    sfp_unpack_kernel<DST_BITS, WORD_BITS, 2, PAIR>
        <<<grid, kThreads, 0, s>>>(payload, bases, out, rows, f);
  }
}

int pack(const void* x, void* payload, void* bases, int rows, int src_bits,
         const int* n_ptr, int man_keep, int dexp_bits, int payload_bits,
         void* stream) {
  if (rows <= 0) return 0;
  if (!fields_ok(src_bits, man_keep, dexp_bits, payload_bits))
    return (int)cudaErrorInvalidValue;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const uint4*>(x);
  auto b = static_cast<uint8_t*>(bases);
  if (src_bits == 16 && payload_bits == 8) launch_pack<16, 8, true>(xi, payload, b, rows, n_ptr, f, s);
  else if (pair_route(src_bits, dexp_bits)) launch_pack<16, 16, true>(xi, payload, b, rows, n_ptr, f, s);
  else if (src_bits == 16) launch_pack<16, 16, false>(xi, payload, b, rows, n_ptr, f, s);
  else if (payload_bits == 8) launch_pack<32, 8, false>(xi, payload, b, rows, n_ptr, f, s);
  else launch_pack<32, 16, false>(xi, payload, b, rows, n_ptr, f, s);
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
  if (!fields_ok(dst_bits, man_keep, dexp_bits, payload_bits))
    return (int)cudaErrorInvalidValue;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bases);
  auto o = static_cast<uint4*>(out);
  if (dst_bits == 16 && payload_bits == 8) launch_unpack<16, 8, true>(payload, b, o, rows, f, s);
  else if (pair_route(dst_bits, dexp_bits)) launch_unpack<16, 16, true>(payload, b, o, rows, f, s);
  else if (dst_bits == 16) launch_unpack<16, 16, false>(payload, b, o, rows, f, s);
  else if (payload_bits == 8) launch_unpack<32, 8, false>(payload, b, o, rows, f, s);
  else launch_unpack<32, 16, false>(payload, b, o, rows, f, s);
  return (int)cudaGetLastError();
}
