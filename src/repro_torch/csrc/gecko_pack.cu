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
// kernels/ref.py.
//
// Bound on this card: memory. The pack moves 64 + 78 bytes per group, the
// unpack 71 + 64; a few dozen integer operations per delta row are far
// below the byte time. Design: a block of 256 threads takes a tile of 32
// groups. It stages the tile's inputs in shared memory with coalesced
// 16-byte loads (a full tile's offsets are multiples of 16 bytes in every
// array: 32 x 63 = 2016 = 16 x 126), one thread per (group, row) computes
// its row, and the block writes the tile's outputs from shared memory with
// 16-byte stores. The (G, 63) and (G, 7) rows are not 4-byte aligned per
// group, which the staging absorbs. A ragged last tile (G not a multiple
// of 32; the JAX kernel edge-pads instead) copies byte by byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 64;         // exponents per group
constexpr int kRows = 7;           // delta rows
constexpr int kPlanes = 9;         // sign + 8 magnitude planes
constexpr int kPlaneBytes = kRows * kPlanes;  // 63
constexpr int kTile = 32;          // groups per block
constexpr int kThreads = kTile * 8;  // one thread per (group, row)

// Copy n bytes global <-> shared: 16-byte words when the caller knows both
// ends are 16-byte aligned and n is a multiple of 16, bytes otherwise.
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int n, bool vec) {
  if (vec) {
    auto d = reinterpret_cast<uint4*>(dst);
    auto s = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n / 16; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
gecko_pack_kernel(const uint8_t* __restrict__ groups,
                  uint8_t* __restrict__ bases, uint8_t* __restrict__ widths,
                  uint8_t* __restrict__ planes, long long n_groups) {
  __shared__ __align__(16) uint8_t s_in[kTile * kGroup];
  __shared__ __align__(16) uint8_t s_bases[kTile * 8];
  __shared__ __align__(16) uint8_t s_widths[kTile * kRows];
  __shared__ __align__(16) uint8_t s_planes[kTile * kPlaneBytes];
  const long long g0 = (long long)blockIdx.x * kTile;
  const long long left = n_groups - g0;
  const int n = left < kTile ? (int)left : kTile;
  const bool vec = n == kTile;
  copy_bytes(s_in, groups + g0 * kGroup, n * kGroup, vec);
  __syncthreads();

  const int g = threadIdx.x >> 3, r = threadIdx.x & 7;
  if (g < n) {
    const uint8_t* base = s_in + g * kGroup;
    if (r == 0) {
      for (int c = 0; c < 8; ++c) s_bases[g * 8 + c] = base[c];
    } else {
      const uint8_t* row = base + r * 8;
      uint32_t sign = 0, row_max = 0, mag[8];
      for (int c = 0; c < 8; ++c) {
        const int d = (int)row[c] - (int)base[c];   // -255..255
        sign |= (uint32_t)(d < 0) << c;              // no sign for d == 0
        mag[c] = (uint32_t)(d < 0 ? -d : d);
        row_max = row_max > mag[c] ? row_max : mag[c];
      }
      s_widths[g * kRows + r - 1] = (uint8_t)(32 - __clz(row_max));  // 0..8
      uint8_t* out = s_planes + g * kPlaneBytes + (r - 1) * kPlanes;
      out[0] = (uint8_t)sign;
      for (int b = 0; b < 8; ++b) {
        uint32_t p = 0;
        for (int c = 0; c < 8; ++c) p |= ((mag[c] >> b) & 1u) << c;
        out[1 + b] = (uint8_t)p;
      }
    }
  }
  __syncthreads();
  copy_bytes(bases + g0 * 8, s_bases, n * 8, vec);
  copy_bytes(widths + g0 * kRows, s_widths, n * kRows, vec);
  copy_bytes(planes + g0 * kPlaneBytes, s_planes, n * kPlaneBytes, vec);
}

__global__ void __launch_bounds__(kThreads)
gecko_unpack_kernel(const uint8_t* __restrict__ bases,
                    const uint8_t* __restrict__ planes,
                    uint8_t* __restrict__ out, long long n_groups) {
  __shared__ __align__(16) uint8_t s_bases[kTile * 8];
  __shared__ __align__(16) uint8_t s_planes[kTile * kPlaneBytes];
  __shared__ __align__(16) uint8_t s_out[kTile * kGroup];
  const long long g0 = (long long)blockIdx.x * kTile;
  const long long left = n_groups - g0;
  const int n = left < kTile ? (int)left : kTile;
  const bool vec = n == kTile;
  copy_bytes(s_bases, bases + g0 * 8, n * 8, vec);
  copy_bytes(s_planes, planes + g0 * kPlaneBytes, n * kPlaneBytes, vec);
  __syncthreads();

  const int g = threadIdx.x >> 3, r = threadIdx.x & 7;
  if (g < n) {
    const uint8_t* base = s_bases + g * 8;
    uint8_t* dst = s_out + g * kGroup + r * 8;
    if (r == 0) {
      for (int c = 0; c < 8; ++c) dst[c] = base[c];
    } else {
      // All 9 planes of the row, whatever its width: the dense form keeps
      // the zeros above it.
      const uint8_t* pl = s_planes + g * kPlaneBytes + (r - 1) * kPlanes;
      uint32_t p[kPlanes];
      for (int b = 0; b < kPlanes; ++b) p[b] = pl[b];
      for (int c = 0; c < 8; ++c) {
        int mag = 0;
        for (int b = 0; b < 8; ++b) mag |= (int)((p[1 + b] >> c) & 1u) << b;
        const int d = ((p[0] >> c) & 1u) ? -mag : mag;
        dst[c] = (uint8_t)((int)base[c] + d);       // wraps to a byte
      }
    }
  }
  __syncthreads();
  copy_bytes(out + g0 * kGroup, s_out, n * kGroup, vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(long long n_groups) {
  return (int)((n_groups + kTile - 1) / kTile);
}

}  // namespace

extern "C" int gecko_pack_launch(const void* groups, void* bases,
                                 void* widths, void* planes,
                                 long long n_groups, void* stream) {
  if (n_groups <= 0) return 0;
  if (!(aligned16(groups) && aligned16(bases) && aligned16(widths)
        && aligned16(planes)) || blocks_for(n_groups) <= 0)
    return (int)cudaErrorInvalidValue;
  gecko_pack_kernel<<<blocks_for(n_groups), kThreads, 0,
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
  if (!(aligned16(bases) && aligned16(planes) && aligned16(out))
      || blocks_for(n_groups) <= 0)
    return (int)cudaErrorInvalidValue;
  gecko_unpack_kernel<<<blocks_for(n_groups), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(planes),
      static_cast<uint8_t*>(out), n_groups);
  return (int)cudaGetLastError();
}
