// Tensor-core building blocks of the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) for Hopper (sm_90a), in inline PTX:
//   - tiles of a (B, S, H, DH) bf16 tensor staged into shared memory by
//     16-byte cp.async, rows past S zero-filled, in the 64-byte swizzled
//     layout that wgmma reads: the columns cut into panels of 32 (64
//     bytes, the swizzle atom), each panel R rows x 64 bytes, 16-byte
//     chunk c of row r stored at chunk c ^ ((r >> 1) & 3). A head dim
//     DH = 16 (mod 32) (144, 240) fills its last panel half: the tile is
//     D = pad32(DH) columns wide and columns DH .. D - 1 are zero-filled
//     (no bytes read). The kernels' reduction over the head dim stops at
//     DH / 16 k-steps, and output columns past DH (products with the
//     zero columns) are never stored. One layout serves as a K-major
//     operand (a row per M or N index, D the reduction: Q K^T) and as an
//     MN-major one (a row per reduction index, D the N columns: P V);
//   - wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators) with both
//     operands in shared memory (N = 32) or A in registers (N = 32, 64, 96,
//     128), and the descriptors, fences and waits around them.
// Fragment layouts (PTX ISA, wgmma register fragments): thread t of a
// warpgroup (warp w = t / 32, lane l) holds accumulator element i of an
// m64nN tile at row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (l % 4) + i % 2. The A fragment of one k16 step is the same layout on
// 16 columns, so accumulator elements 8 kk .. 8 kk + 7 of a score tile,
// rounded to bf16 in pairs, are the A registers of reduction step kk.
#pragma once

#include "sfp_common.cuh"

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kMaxDevices = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 64-byte swizzle of a byte offset from a 512-byte-aligned tile base:
// address bits [4, 6) ^= bits [7, 9), as wgmma's 64B layout reads them.
__device__ __forceinline__ uint32_t sw64(uint32_t off) {
  return off ^ ((off >> 3) & 0x30u);
}

// The tile width of a head dim: whole 32-column panels.
__host__ __device__ constexpr int pad32(int d) { return (d + 31) / 32 * 32; }

// Bytes of an R-row tile of D bf16 columns, and the stride between its
// 32-column panels.
template <int R, int D>
struct Tile {
  static constexpr int kPanel = R * 64;
  static constexpr int kBytes = R * D * 2;
  static_assert(R % 8 == 0 && D % 32 == 0, "tile not made of swizzle atoms");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every copy this thread issued, make the shared-memory writes
// visible to the tensor cores' (async proxy) reads, then the CTA barrier.
__device__ __forceinline__ void cp_async_land() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Rows [row0, row0 + R) of one head of a (B, S, H, DH) bf16 tensor (src
// points at row 0 of that head; rows are H * DH apart) into the swizzled
// panel layout of a D-column tile at dst; rows at or past S, and columns
// DH .. D - 1, are zeros. NT threads share it.
template <int R, int D, int NT, int DH = D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row_stride, int row0, int S,
                                          int tid) {
  static_assert(DH % 16 == 0 && DH <= D && D - DH < 32, "head dim");
  constexpr int C = D / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int idx = tid; idx < R * C; idx += NT) {
    const int r = idx / C, c = idx - r * C;
    const bool ok = row0 + r < S && c < DH / 8;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * row_stride
                    + (ok ? c * 8 : 0);
    const uint32_t off = (c >> 2) * Tile<R, D>::kPanel + r * 64 + (c & 3) * 16;
    cp_async16(dst + sw64(off), g, ok);
  }
}

// n floats [i0, i0 + n) of an f32 vector into shared memory, zeros past
// `end`: thread t in [0, n) copies float t (4 bytes: the vector need not be
// 16-byte aligned).
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src,
                                         int i0, int n, int end, int t) {
  if (t >= 0 && t < n)
    cp_async4(dst + t * 4, src + min(i0 + t, end - 1), i0 + t < end);
}

// wgmma matrix descriptor of a 64B-swizzled operand at shared address
// `addr`: lbo = byte stride between 32-column panels along MN (MN-major;
// unused for K-major), sbo = byte stride between 8-row groups (512).
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32)
         | ((uint64_t)2 << 62);
}

// A descriptor through an opaque move: the compiler derives each k-step's
// descriptor from it where the wgmma needs it, instead of hoisting one
// 64-bit register pair a k-step out of the tile loop, where the
// accumulators need the registers.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(d));
  return d;
}

// K-major operand: rows [0, 64) or [0, N) from `rows0` (a row offset in
// bytes inside each panel), reduction step kk (16 columns). The start
// address is the descriptor's low field, in 16-byte units.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, uint32_t rows0,
                                           int kk) {
  return opaque(desc64(tile + rows0, 16, 512))
         + (((kk >> 1) * (R * 64) + (kk & 1) * 32) >> 4);
}

// MN-major operand: reduction rows 16 kk .. 16 kk + 15, N columns from
// panel p0.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int p0, int kk) {
  return opaque(desc64(tile, R * 64, 512))
         + ((p0 * (R * 64) + kk * 1024) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int T, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[T][N][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile("" : "+r"(a[t][i][j]) :: "memory");
}

// Accumulator elements 8 kk .. 8 kk + 7 of an m64nN tile (N / 2 floats a
// thread) as the A registers of reduction step kk, each value split into
// T bf16 terms: a[0] its bf16 rounding, a[t] that of what a[0 .. t - 1]
// leave (T = 3 keeps 24 significant bits). Each subtraction is exact, so
// the terms sum to x - (the last residual); row_sum[r] adds that sum over
// this thread's elements of row r (accumulator rows l / 4, l / 4 + 8).
template <int T, int N>
__device__ __forceinline__ void to_a_terms(const float (&s)[N],
                                           uint32_t (&a)[T][N / 8][4],
                                           float (&row_sum)[2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
      float r0 = x0, r1 = x1;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
        const float2 hf = __bfloat1622float2(h);
        r0 -= hf.x;
        r1 -= hf.y;
        a[t][kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      row_sum[j & 1] += (x0 - r0) + (x1 - r1);
    }
}

// Whether every (row, key) pair of folded rows [r_lo, r_hi] and keys
// [k_lo, k_hi] is visible: then the tile skips the mask arithmetic. Keys
// below prefix_len (a prefix-LM's conditioning) are visible to every row.
// kernels/flash_attention.py:tile_plan computes the same predicate.
__device__ __forceinline__ bool tile_open(int r_lo, int r_hi, int k_lo,
                                          int k_hi, int Sk, int q_rep,
                                          int causal, int window,
                                          int prefix_len) {
  if (k_hi >= Sk) return false;
  if (k_hi < prefix_len) return true;
  if (causal && k_hi > r_lo / q_rep) return false;
  if (window > 0 && k_lo <= r_hi / q_rep - window) return false;
  return true;
}

// The JAX package's mask: (causal & window) | key < prefix_len.
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window,
                                        int prefix_len) {
  return kpos < Sk && (kpos < prefix_len
                       || ((!causal || kpos <= qpos)
                           && (window <= 0 || kpos > qpos - window)));
}

// The key range [begin, end) a query block of positions [q_lo, q_hi] can
// see: causal and window bounds, widened to take the prefix's keys.
__device__ __forceinline__ void key_range(int q_lo, int q_hi, int Sk,
                                          int causal, int window,
                                          int prefix_len, int& begin,
                                          int& end) {
  end = causal ? min(Sk, q_hi + 1) : Sk;
  begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  if (prefix_len > 0) {
    begin = 0;
    end = max(end, min(Sk, prefix_len));
  }
}

// The largest dynamic shared memory each kernel instance needs, granted
// once per device (not on every launch).
template <typename K>
int grant_smem(K kernel, int bytes, int (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (granted[dev] != bytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = bytes;
  }
  return 0;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// wgmma wrappers: the overload is chosen by the accumulator's size (N / 2
// floats a thread).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace attn
