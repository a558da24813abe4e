// Dense bit-plane SFP pack, fused quantize+pack and unpack for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/bitplane_pack.py:
// bitplane_pack (_bitplane_pack_kernel), bitplane_quantize_pack
// (_bitplane_quantize_pack_kernel) and bitplane_unpack
// (_bitplane_unpack_kernel). Input of the packs: R rows of 128 bf16 or
// f32 values. Each value becomes the payload word of sfp_pack.cu (with the
// optional fused Q(M, n), n read from device memory), P = 1 + E + K bits
// wide (3..16), and the words of a row are stored as P byte-aligned bit
// planes: plane p is 16 bytes, byte i holds bit p of lanes 8i..8i+7 (bit
// j <-> lane 8i+j), planes LSB first, so a row is P * 16 bytes. One uint8
// base per row (max biased exponent). The unpack is the inverse into bf16
// or f32. The plain versions are bitplane_pack_rows / bitplane_unpack_rows
// in kernels/ref.py; bitplane_{pack,unpack}_swar there mirror the
// arithmetic below step for step.
//
// Bound on this card: bytes, once the integer work per value is small. A
// bf16 value is read once (2 B) and leaves as P/8 bytes plus 1/128 of a
// base byte; the unpack moves the same bytes the other way. The card
// issues 64 integer operations a clock an SM, so at the stash shape
// (9.4 M values) every 10 operations a value cost ~6 us against a byte
// bound of ~8 us. Design:
// 1. A thread per 8 lanes. 16 threads make a row (a half-warp), a block of
//    256 threads 16 rows a pass. A thread loads its 8 values of a pass with
//    one 16-byte load (f32: two). Up to the rows an H100 holds at once with
//    one pass (8 blocks on each of 132 SMs), a tile is one pass, so a
//    one-token pack of 36 rows is one load and one row a thread; above, a
//    tile is two passes, both loads in flight before any arithmetic. (On
//    the H100, two passes at one token, one or four passes at the stash
//    shape, persistent blocks with the next tile's loads in flight, or a
//    32-register cap were slower; PERF.md.)
// 2. Two bf16 values a register. The encode and decode run on both 16-bit
//    halves at once (encode_pair, decode_pair; sfp_pair.cuh): no carry or
//    borrow crosses a half, so ~8 operations a value replace
//    sfp_encode_word's ~14 and sfp_decode_word's ~16. f32 takes those two
//    unchanged, one value a register.
// 3. The row base is a max over the half-warp: 4 __shfl_xor_sync.
// 4. Planes by register transpose: the low bytes of the thread's 8 words
//    form one 8x8 bit matrix (byte j = lane j), and one transpose8x8
//    (swar.cuh) turns it into byte t of planes 0-7 (byte p = plane p); the
//    high bytes give planes 8-15 by a second one when P > 8. The unpack
//    runs the same transposes back (each is its own inverse).
// 5. Tile-staged stores and loads. The tile's rows are contiguous in global
//    memory (row stride P * 16 bytes), so the pack writes each thread's P
//    plane bytes into a shared-memory image of the tile and then the block
//    writes the image, and the tile's bases, out with 16-byte stores; the
//    unpack copies the tile's planes into shared memory with 16-byte
//    cp.async and each thread gathers its P bytes from there. A ragged last
//    tile moves only its own rows (every row is a multiple of 16 bytes).
// Integer arithmetic only, so the results are bit-for-bit the plain
// versions'.
#include "sfp_common.cuh"
#include "sfp_pair.cuh"
#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 16;                    // 8 lanes a thread
constexpr int kRowsPerPass = kThreads / kRowThreads;
constexpr int kMaxPlanes = 16;
// Rows an H100 holds at once with one pass: 8 blocks on each of 132 SMs.
constexpr int kOnePassRows = 8 * 132 * kRowsPerPass;

// The thread's 8 payload words as pairs (word 2k in the low half of w[k])
// into byte t of each plane in the shared-memory image of its row s.
__device__ __forceinline__ void put_planes(uint8_t* s, const uint32_t w[4],
                                           int P) {
  uint32_t lo = __byte_perm(w[0], w[1], 0x6420);   // low bytes, words 0-3
  uint32_t hi = __byte_perm(w[2], w[3], 0x6420);   // words 4-7
  transpose8x8(lo, hi);                            // byte p: plane p
  uint32_t lo2 = 0u, hi2 = 0u;
  if (P > 8) {
    lo2 = __byte_perm(w[0], w[1], 0x7531);         // high bytes
    hi2 = __byte_perm(w[2], w[3], 0x7531);
    transpose8x8(lo2, hi2);                        // byte p: plane 8 + p
  }
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    if (p < P) {
      const uint32_t b = p < 4 ? lo : p < 8 ? hi : p < 12 ? lo2 : hi2;
      s[16 * p] = (uint8_t)(b >> (8 * (p & 3)));
    }
  }
}

// The inverse: byte t of each plane of row s into the 8 words as pairs.
__device__ __forceinline__ void get_planes(const uint8_t* s, uint32_t w[4],
                                           int P) {
  uint32_t q[4] = {0u, 0u, 0u, 0u};                // lo, hi, lo2, hi2
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p)
    if (p < P) q[p >> 2] |= (uint32_t)s[16 * p] << (8 * (p & 3));
  transpose8x8(q[0], q[1]);                        // byte j: lane j, bits 0-7
  if (P > 8) transpose8x8(q[2], q[3]);             // bits 8-15
  w[0] = __byte_perm(q[0], q[2], 0x5140);
  w[1] = __byte_perm(q[0], q[2], 0x7362);
  w[2] = __byte_perm(q[1], q[3], 0x5140);
  w[3] = __byte_perm(q[1], q[3], 0x7362);
}

template <int SRC_BITS, int U>
__global__ void __launch_bounds__(kThreads)
bitplane_pack_kernel(const uint4* __restrict__ x, uint8_t* __restrict__ planes,
                     uint8_t* __restrict__ bases, int rows,
                     const int* __restrict__ n_ptr, SfpFields f) {
  constexpr int kTile = kRowsPerPass * U;          // U passes a tile
  constexpr int kLoads = SRC_BITS / 16;            // 16-byte loads a row
  constexpr int man_bits = SRC_BITS == 16 ? 7 : 23;
  __shared__ __align__(16) uint8_t img[kTile * kMaxPlanes * 16 + kTile];
  uint8_t* img_bases = img + kTile * kMaxPlanes * 16;
  const int t = threadIdx.x % kRowThreads, q = threadIdx.x / kRowThreads;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int n_rows = (int)min((long long)kTile, rows - row0);
  const int P = f.payload_bits, row_bytes = 16 * P;

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
  const int dmax = f.dexp_max();
  PairFields c{};
  if constexpr (SRC_BITS == 16) c = pair_fields(f, keep & 0x7Fu);

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;            // the half-warp's row
    uint32_t w[4];
    int base;
    if constexpr (SRC_BITS == 16) {
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
        w[k] = encode_pair(u2[k], y2[k], ek2[k], c2, twice(baseK), c);
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
      put_planes(img + r * row_bytes + t, w, P);
      if (t == 0) img_bases[r] = (uint8_t)base;
    }
  }
  __syncthreads();

  // The tile's planes and bases leave as 16-byte stores; a ragged last
  // tile writes its own rows (and the bytes of a partial base chunk).
  uint4* dst = reinterpret_cast<uint4*>(planes + row0 * row_bytes);
  const uint4* src = reinterpret_cast<const uint4*>(img);
  for (int i = threadIdx.x; i < n_rows * P; i += kThreads) dst[i] = src[i];
  const int i = threadIdx.x;
  if (16 * i + 16 <= n_rows) {
    reinterpret_cast<uint4*>(bases + row0)[i] =
        reinterpret_cast<const uint4*>(img_bases)[i];
  } else if (16 * i < n_rows) {
    for (int b = 16 * i; b < n_rows; ++b) bases[row0 + b] = img_bases[b];
  }
}

template <int DST_BITS, int U>
__global__ void __launch_bounds__(kThreads)
bitplane_unpack_kernel(const uint8_t* __restrict__ planes,
                       const uint8_t* __restrict__ bases,
                       uint4* __restrict__ out, int rows, SfpFields f) {
  constexpr int kTile = kRowsPerPass * U;
  constexpr int kStores = DST_BITS / 16;           // 16-byte stores a row
  __shared__ __align__(16) uint8_t img[kTile * kMaxPlanes * 16];
  const int t = threadIdx.x % kRowThreads, q = threadIdx.x / kRowThreads;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int n_rows = (int)min((long long)kTile, rows - row0);
  const int P = f.payload_bits, row_bytes = 16 * P;

  const uint8_t* src = planes + row0 * row_bytes;
  for (int i = threadIdx.x; i < n_rows * P; i += kThreads)
    cp_async16(img + 16 * i, src + 16 * i, 16);
  cp_async_commit();
  int base[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;
    base[u] = r < n_rows ? (int)__ldg(bases + row0 + r) : 0;
  }
  PairFields c{};
  if constexpr (DST_BITS == 16) c = pair_fields(f, 0x7Fu);
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = q + kRowsPerPass * u;
    if (r >= n_rows) break;
    uint32_t w[4];
    get_planes(img + r * row_bytes + t, w, P);
    uint4* o = out + (row0 + r) * (16 * kStores) + kStores * t;
    if constexpr (DST_BITS == 16) {
      const uint32_t b2 = twice(((uint32_t)base[u] + 256u) << 7);
      *o = make_uint4(decode_pair(w[0], b2, c), decode_pair(w[1], b2, c),
                      decode_pair(w[2], b2, c), decode_pair(w[3], b2, c));
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

// A bf16 holds K <= 7 mantissa bits.
bool fields_ok(int float_bits, int man_keep, int dexp_bits,
               int payload_bits) {
  return (float_bits == 16 || float_bits == 32) && payload_bits >= 3
         && payload_bits <= kMaxPlanes && man_keep >= 1 && dexp_bits >= 1
         && dexp_bits <= 8 && 1 + dexp_bits + man_keep == payload_bits
         && (float_bits == 32 || man_keep <= 7);
}

int pack(const void* x, void* planes, void* bases, int rows, int src_bits,
         const int* n_ptr, int man_keep, int dexp_bits, int payload_bits,
         void* stream) {
  if (rows <= 0) return 0;
  if (!fields_ok(src_bits, man_keep, dexp_bits, payload_bits))
    return (int)cudaErrorInvalidValue;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const uint4*>(x);
  auto p = static_cast<uint8_t*>(planes);
  auto b = static_cast<uint8_t*>(bases);
  const bool one = rows <= kOnePassRows;
  const int tile = kRowsPerPass * (one ? 1 : 2);
  const int grid = (rows + tile - 1) / tile;
  if (src_bits == 16 && one)
    bitplane_pack_kernel<16, 1><<<grid, kThreads, 0, s>>>(xi, p, b, rows,
                                                          n_ptr, f);
  else if (src_bits == 16)
    bitplane_pack_kernel<16, 2><<<grid, kThreads, 0, s>>>(xi, p, b, rows,
                                                          n_ptr, f);
  else if (one)
    bitplane_pack_kernel<32, 1><<<grid, kThreads, 0, s>>>(xi, p, b, rows,
                                                          n_ptr, f);
  else
    bitplane_pack_kernel<32, 2><<<grid, kThreads, 0, s>>>(xi, p, b, rows,
                                                          n_ptr, f);
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
  if (!fields_ok(dst_bits, man_keep, dexp_bits, payload_bits))
    return (int)cudaErrorInvalidValue;
  const SfpFields f{man_keep, dexp_bits, payload_bits};
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint8_t*>(planes);
  auto b = static_cast<const uint8_t*>(bases);
  auto o = static_cast<uint4*>(out);
  const bool one = rows <= kOnePassRows;
  const int tile = kRowsPerPass * (one ? 1 : 2);
  const int grid = (rows + tile - 1) / tile;
  if (dst_bits == 16 && one)
    bitplane_unpack_kernel<16, 1><<<grid, kThreads, 0, s>>>(p, b, o, rows, f);
  else if (dst_bits == 16)
    bitplane_unpack_kernel<16, 2><<<grid, kThreads, 0, s>>>(p, b, o, rows, f);
  else if (one)
    bitplane_unpack_kernel<32, 1><<<grid, kThreads, 0, s>>>(p, b, o, rows, f);
  else
    bitplane_unpack_kernel<32, 2><<<grid, kThreads, 0, s>>>(p, b, o, rows, f);
  return (int)cudaGetLastError();
}
