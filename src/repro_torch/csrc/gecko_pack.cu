// Gecko delta-mode exponent pack and unpack (paper §IV-C) for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/gecko_pack.py: gecko_pack and
// gecko_unpack. A group is 64 uint8 exponents viewed as an 8x8 matrix: row
// 0 holds the 8 column bases, rows 1..7 the sign+magnitude deltas against
// them as bit planes (byte [row, p] holds bit p of all 8 columns, bit c for
// column c; p = 0 is the sign plane, p = 1..8 the magnitude planes). The
// pack writes bases (G, 8), row widths (G, 7) in 0..8 and the dense planes
// (G, 63); the unpack reads bases and planes back into (G, 64) exponents.
// The plain versions are gecko_plane_encode / gecko_plane_decode in
// kernels/ref.py; gecko_plane_{encode,decode}_swar there mirror the
// arithmetic below step for step.
//
// Bound on this card: bytes, once the rows are done by SWAR. The pack
// moves 64 + 78 bytes per group, the unpack 71 + 64. Building or reading
// the 8 magnitude planes one bit at a time costs ~1,000-2,000 integer
// operations a group, more than the card issues in the byte time. Design:
// 1. Rows in registers. A lane owns a group and holds each row as two
//    words (columns 0-3, 4-7). The pack takes the magnitudes and the sign
//    mask with byte-SIMD intrinsics (__vabsdiffu4, __vcmpltu4), collapses
//    the mask into the sign byte with one multiply a word, takes the width
//    as the bit length of the OR of the magnitudes (bitlength(max) =
//    bitlength(OR)), and turns the 8 magnitude bytes (byte c = column c)
//    into the 8 planes (byte b = plane b) by one 8x8 bit transpose, three
//    delta swaps (transpose8x8, swar.cuh). The unpack runs the same
//    transpose (its own inverse), spreads the sign byte into a byte mask n
//    with one multiply a word, and forms base +- mag as __vadd4(base ^ n,
//    mag) ^ n (bytewise, x - y = ~(~x + y)).
// 2. Warp tiles, no block barrier. A warp owns tiles of 32 groups, whose
//    offsets are multiples of 16 bytes in every array (32 x 7 = 224, 32 x
//    63 = 2016). It stages a tile into a two-slot ring of its own in shared
//    memory with coalesced 16-byte cp.async copies, the next tile's copies
//    in flight while this one computes, and syncs with __syncwarp only. The
//    grid is what the card holds at once, each warp striding over the
//    tiles, so a small G (one token: 72 groups) runs on a few warps with
//    one load, one compute and one store on its critical path.
// 3. Unaligned records through shared memory. A group's 63 plane bytes and
//    7 widths start at any byte. A lane reads its record as aligned words
//    realigned by funnel shifts, and writes it as aligned interior words
//    plus three edge bytes, so no two lanes write one word. Outputs leave
//    the slot as coalesced 16-byte stores; the bases go out of registers, 8
//    bytes a lane. The 64-byte groups sit swizzled in shared memory (chunk
//    p of group q at chunk p ^ (bits 1-2 of q)): a lane's 16-byte reads and
//    writes of its group meet no bank conflict.
// 4. Any G, no padding: a ragged last tile copies only its valid bytes
//    (cp.async fills the rest with zeros), lanes past G compute on what the
//    slot holds and store nothing, and a partial 16-byte chunk of an output
//    is written byte by byte.
// In practice (H100, PERF.md) the row arithmetic hides behind the memory
// path: a third ring slot, 2 or 8 warps a block, or a grid capped below
// what fits did not make either kernel faster.
#include <cstdint>
#include <cuda_runtime.h>

#include "swar.cuh"

namespace {

constexpr int kGroup = 64;         // exponents per group
constexpr int kRows = 7;           // delta rows
constexpr int kPlanes = 9;         // sign + 8 magnitude planes
constexpr int kPlaneBytes = kRows * kPlanes;  // 63
constexpr int kTile = 32;          // groups a warp tile: one a lane
constexpr int kWarps = 4;          // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;         // ring slots a warp: tiles in flight
constexpr int kMaxDevices = 64;
// A pack slot holds the tile's groups (2048 bytes, swizzled), then its
// planes [0, 2016) and widths [2016, 2240).
constexpr int kPackSlot = kTile * (kPlaneBytes + kRows);
// An unpack slot holds bases [0, 256), planes [256, 2272) and 16 bytes that
// a record's realigning read may touch, then the tile's groups (swizzled).
constexpr int kBasesBytes = kTile * 8;
constexpr int kUnpackSlot = kBasesBytes + kTile * kPlaneBytes + 16;
static_assert(kPackSlot % 16 == 0 && kUnpackSlot % 16 == 0, "slot align");
static_assert(kStages >= 2, "a slot loads while another computes");
static_assert(kPackSlot >= kTile * kGroup && kUnpackSlot >= kTile * kGroup,
              "a slot holds the tile's groups");

// Shared-memory offset of 16-byte chunk c of a tile of 64-byte groups.
__device__ __forceinline__ int swz(int c) {
  const int q = c >> 2;
  return 64 * q + 16 * ((c ^ (q >> 1)) & 3);
}

template <bool kSwizzled>
__device__ __forceinline__ int chunk_at(int c) {
  return kSwizzled ? swz(c) : 16 * c;
}

// The warp copies the first `bytes` bytes at src (16-byte aligned) into
// shared memory, asynchronously, in 16-byte chunks; the last chunk takes
// its valid bytes and zeros.
template <bool kSwizzled>
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int bytes, int lane) {
  for (int c = lane; 16 * c < bytes; c += 32) {
    const int left = bytes - 16 * c;
    cp_async16(dst + chunk_at<kSwizzled>(c), src + 16 * c,
               left < 16 ? left : 16);
  }
}

// The warp writes `bytes` bytes from shared memory to dst (16-byte
// aligned): 16-byte stores, the bytes of a partial last chunk one by one.
template <bool kSwizzled>
__device__ __forceinline__ void flush(uint8_t* dst, const uint8_t* src,
                                      int bytes, int lane) {
  for (int c = lane; 16 * c < bytes; c += 32) {
    const uint8_t* s = src + chunk_at<kSwizzled>(c);
    if (16 * c + 16 <= bytes) {
      *reinterpret_cast<uint4*>(dst + 16 * c) =
          *reinterpret_cast<const uint4*>(s);
    } else {
      for (int i = 0; i < bytes - 16 * c; ++i) dst[16 * c + i] = s[i];
    }
  }
}

// A record of 4N - 1 bytes at byte o of s, any alignment, as N words
// (byte k in word k / 4): N + 1 aligned reads, funnel-shifted.
template <int N>
__device__ __forceinline__ void load_record(const uint8_t* s, int o,
                                            uint32_t (&R)[N]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s + (o & ~3));
  const uint32_t sh = 8u * (o & 3);
  uint32_t a = w[0];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const uint32_t b = w[m + 1];
    R[m] = __funnelshift_r(a, b, sh);
    a = b;
  }
}

// The inverse: h = (-o) & 3 head bytes, N - 1 aligned interior words and
// 3 - h tail bytes, so only the record's own bytes are written.
template <int N>
__device__ __forceinline__ void store_record(uint8_t* s, int o,
                                             const uint32_t (&R)[N]) {
  const int h = (-o) & 3;
  const uint32_t sh = 8u * h;
  uint32_t* w = reinterpret_cast<uint32_t*>(s + o + h);
#pragma unroll
  for (int m = 0; m + 1 < N; ++m) w[m] = __funnelshift_r(R[m], R[m + 1], sh);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    if (e < h) s[o + e] = (uint8_t)(R[0] >> (8 * e));
    else s[o + 4 * N - 4 + e] = (uint8_t)(R[N - 1] >> (8 * e));
  }
}

// Delta row r's 9 bytes (sign byte, planes 1-4 in lo, 5-8 in hi) into
// bytes 9r..9r+8 of the 63-byte record (R zeroed first; r a constant).
__device__ __forceinline__ void put_row(uint32_t (&R)[16], int r, uint32_t s,
                                        uint32_t lo, uint32_t hi) {
  const int w = 9 * r / 4;
  const uint32_t q = 8u * ((9 * r) % 4);
  const uint32_t v0 = __byte_perm(s, lo, 0x6540);   // s, lo bytes 0-2
  const uint32_t v1 = __byte_perm(lo, hi, 0x6543);  // lo byte 3, hi 0-2
  const uint32_t v2 = hi >> 24;                     // hi byte 3
  R[w] |= v0 << q;
  R[w + 1] |= __funnelshift_l(v0, v1, q);
  R[w + 2] |= __funnelshift_l(v1, v2, q);
}

// The inverse of put_row.
__device__ __forceinline__ void get_row(const uint32_t (&R)[16], int r,
                                        uint32_t& s, uint32_t& lo,
                                        uint32_t& hi) {
  const int w = (9 * r + 1) / 4;
  const uint32_t q = 8u * ((9 * r + 1) % 4);
  s = (R[9 * r / 4] >> (8 * ((9 * r) % 4))) & 0xFFu;
  lo = __funnelshift_r(R[w], R[w + 1], q);
  hi = __funnelshift_r(R[w + 1], R[w + 2], q);
}

// Bit i of the result is bit 0 of byte i of m (4 bits): the cross terms
// of the multiply land on distinct bits below 28.
__device__ __forceinline__ uint32_t movemask4(uint32_t m) {
  return ((m & 0x01010101u) * 0x10204080u) >> 28;
}

// The inverse: byte i is 0xFF where bit i of the nibble x is set.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x * 0x00204081u) & 0x01010101u) * 0xFFu;
}

__device__ __forceinline__ int tile_groups(long long t, long long n_groups) {
  const long long left = n_groups - t * kTile;
  return left < kTile ? (int)left : kTile;
}

__global__ void __launch_bounds__(kThreads)
gecko_pack_kernel(const uint8_t* __restrict__ groups,
                  uint8_t* __restrict__ bases, uint8_t* __restrict__ widths,
                  uint8_t* __restrict__ planes, long long n_groups) {
  __shared__ __align__(16) uint8_t ring[kWarps][kStages][kPackSlot];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long n_tiles = (n_groups + kTile - 1) / kTile;
  const long long stride = (long long)gridDim.x * kWarps;
  long long t = (long long)blockIdx.x * kWarps + wid;
  auto load = [&](int slot, long long tt) {
    if (tt < n_tiles)
      stage<true>(ring[wid][slot], groups + tt * kTile * kGroup,
                  tile_groups(tt, n_groups) * kGroup, lane);
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) load(k, t + k * stride);
  for (int i = 0; t < n_tiles; t += stride, ++i) {
    load((i + kStages - 1) % kStages, t + (kStages - 1) * stride);
    cp_async_wait<kStages - 1>();  // this tile's copies have landed
    __syncwarp();
    uint8_t* s = ring[wid][i % kStages];
    const int n = tile_groups(t, n_groups);
    uint32_t x[16];  // the group, row r in x[2r] (columns 0-3), x[2r + 1]
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(s + swz(4 * lane + p));
      x[4 * p] = v.x; x[4 * p + 1] = v.y; x[4 * p + 2] = v.z;
      x[4 * p + 3] = v.w;
    }
    __syncwarp();  // every lane holds its group: the slot takes the outputs
    if (lane < n)
      *reinterpret_cast<uint2*>(bases + 8 * (t * kTile + lane)) =
          make_uint2(x[0], x[1]);
    uint32_t R[16] = {}, W[2] = {};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t a = x[2 * r + 2], b = x[2 * r + 3];
      uint32_t lo = __vabsdiffu4(a, x[0]), hi = __vabsdiffu4(b, x[1]);
      const uint32_t sign = movemask4(__vcmpltu4(a, x[0]))
          | (movemask4(__vcmpltu4(b, x[1])) << 4);  // no sign for 0
      uint32_t m = lo | hi;
      m |= m >> 16;
      m |= m >> 8;
      W[r / 4] |= (uint32_t)(32 - __clz(m & 0xFFu)) << (8 * (r % 4));
      transpose8x8(lo, hi);  // byte b: bit b of the 8 magnitudes
      put_row(R, r, sign, lo, hi);
    }
    store_record(s, kPlaneBytes * lane, R);
    store_record(s + kTile * kPlaneBytes, kRows * lane, W);
    __syncwarp();
    flush<false>(planes + t * kTile * kPlaneBytes, s, n * kPlaneBytes, lane);
    flush<false>(widths + t * kTile * kRows, s + kTile * kPlaneBytes,
                 n * kRows, lane);
    __syncwarp();  // the slot is free for the copies kStages tiles on
  }
}

__global__ void __launch_bounds__(kThreads)
gecko_unpack_kernel(const uint8_t* __restrict__ bases,
                    const uint8_t* __restrict__ planes,
                    uint8_t* __restrict__ out, long long n_groups) {
  __shared__ __align__(16) uint8_t ring[kWarps][kStages][kUnpackSlot];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long n_tiles = (n_groups + kTile - 1) / kTile;
  const long long stride = (long long)gridDim.x * kWarps;
  long long t = (long long)blockIdx.x * kWarps + wid;
  auto load = [&](int slot, long long tt) {
    if (tt < n_tiles) {
      const int n = tile_groups(tt, n_groups);
      uint8_t* s = ring[wid][slot];
      stage<false>(s, bases + tt * kBasesBytes, n * 8, lane);
      stage<false>(s + kBasesBytes, planes + tt * kTile * kPlaneBytes,
                   n * kPlaneBytes, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) load(k, t + k * stride);
  for (int i = 0; t < n_tiles; t += stride, ++i) {
    load((i + kStages - 1) % kStages, t + (kStages - 1) * stride);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    uint8_t* s = ring[wid][i % kStages];
    const uint2 base = *reinterpret_cast<const uint2*>(s + 8 * lane);
    uint32_t R[16];
    load_record(s + kBasesBytes, kPlaneBytes * lane, R);
    __syncwarp();  // every lane holds its inputs: the slot takes the groups
    uint32_t y[16];
    y[0] = base.x;
    y[1] = base.y;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // All 9 planes of the row, whatever its width: the dense form keeps
      // the zeros above it.
      uint32_t sign, lo, hi;
      get_row(R, r, sign, lo, hi);
      transpose8x8(lo, hi);  // byte c: the magnitude of column c
      // Bytewise x - y = ~(~x + y): base - mag where the mask n is 0xFF.
      const uint32_t na = spread4(sign & 0xFu), nb = spread4(sign >> 4);
      y[2 * r + 2] = __vadd4(base.x ^ na, lo) ^ na;
      y[2 * r + 3] = __vadd4(base.y ^ nb, hi) ^ nb;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<uint4*>(s + swz(4 * lane + p)) =
          make_uint4(y[4 * p], y[4 * p + 1], y[4 * p + 2], y[4 * p + 3]);
    __syncwarp();
    flush<true>(out + t * kTile * kGroup, s,
                tile_groups(t, n_groups) * kGroup, lane);
    __syncwarp();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The grid: one warp a tile, capped at the blocks the card holds at once
// (SMs x blocks an SM), found once per device and kernel.
template <int kWhich>
int grid_for(const void* kernel, long long n_groups) {
  static int resident[kMaxDevices];  // 0: not yet asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return -(int)err;
    if (sms * per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const long long tiles = (n_groups + kTile - 1) / kTile;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  return blocks < resident[dev] ? (int)blocks : resident[dev];
}

}  // namespace

extern "C" int gecko_pack_launch(const void* groups, void* bases,
                                 void* widths, void* planes,
                                 long long n_groups, void* stream) {
  if (n_groups <= 0) return 0;
  if (!(aligned16(groups) && aligned16(bases) && aligned16(widths)
        && aligned16(planes)))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for<0>((const void*)gecko_pack_kernel, n_groups);
  if (grid < 0) return -grid;
  gecko_pack_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(groups), static_cast<uint8_t*>(bases),
      static_cast<uint8_t*>(widths), static_cast<uint8_t*>(planes),
      n_groups);
  return (int)cudaGetLastError();
}

extern "C" int gecko_unpack_launch(const void* bases, const void* planes,
                                   void* out, long long n_groups,
                                   void* stream) {
  if (n_groups <= 0) return 0;
  if (!(aligned16(bases) && aligned16(planes) && aligned16(out)))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for<1>((const void*)gecko_unpack_kernel, n_groups);
  if (grid < 0) return -grid;
  gecko_unpack_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(planes),
      static_cast<uint8_t*>(out), n_groups);
  return (int)cudaGetLastError();
}
