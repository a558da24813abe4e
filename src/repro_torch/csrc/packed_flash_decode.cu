// Fused decompress-attend decode over an SFP-packed KV cache, contiguous
// or paged.
//
// Replaces the TPU kernels src/repro/kernels/packed_flash_decode.py:
// packed_flash_decode (_decode_kernel) and paged_flash_decode
// (_paged_kernel), each with its fixed-lane word branch, its dense
// bit-plane branch and its prefix_planes draft read mode. One query token per batch row attends an L-slot
// cache stored as payload words (B, L, KH*hd) uint8/uint16, or as dense
// bit planes (B, L, G*P*16) uint8 ordered (group, plane, 16 bytes) per
// slot, plus one uint8 base per 128-lane group (B, L, G = KH*hd/128).
// Groups run along the flattened KH*hd axis and may
// straddle heads (hd = 288: 9 groups over 4 heads), so a feature's base is
// found by (flat feature index / 128). Per-row decode positions; a
// window > 0 means an L-slot ring buffer (floor mod, as the JAX mask).
// The recurrence is the JAX kernel's: per block_l-slot tile, scores in
// f32, softcap, -1e30 on masked slots, online softmax, acc += p . v.
//
// Bound on this card: memory. Each live slot costs (D + D/128) bytes for K
// and again for V with 8-bit words. Design, simple first: one CTA of 256
// threads per (batch row, KV head). Per tile the CTA stages the head's
// packed K and V rows and their group bases into shared memory with 4-byte
// loads, expands words to f32 in registers with the word bit machine (the
// bf16 cache never exists in device memory), takes q.k for the rep query
// heads of that KV head (one warp per slot, shuffle reduction), runs the
// online softmax (one warp per query head) and accumulates p.v (one thread
// per feature). Tiles that no slot of the row may see are skipped, an exact
// no-op of the JAX recurrence. Only B*KH CTAs run: split-KV is later work.
//
// Dense planes: a 32-feature chunk c of the flattened axis is uint32 k = c%4
// of each plane of group c/4, so head h needs chunks h*hd/32 ..
// (h*hd+hd-1)/32 (at hd = 288: 9 chunks over 3 groups; groups 2, 4 and 6
// are shared by two heads). Staging gives one warp per (slot, chunk): lanes
// 0..P-1 load plane p's uint32 (one 4-byte read each, so the bf16 cache is
// never read or written), and lane t rebuilds the word of feature 32c+t
// from bit t of the P plane words, taken by warp shuffles. The words land
// in the same shared tile as the fixed-lane branch (1 byte for P <= 8,
// else 2), so the scores and p.v loops are shared and the tile is as large
// for any P; each feature's word is then decoded by sfp_decode_word.
//
// Draft read (prefix_planes P' < P): only the leading P' bits of each
// word are decoded, as the narrow geometry (man_keep - (P - P') mantissa
// bits; ref.prefix_fields). Fixed-lane words are staged as stored and
// shifted right by P - P' in a register before the decode (same bytes
// read). Dense planes are stored LSB-plane first, so the staging loads
// only planes P-P' .. P-1 of each group and rebuilds P'-bit words: the
// read shrinks with P', and the word tile is 1 byte when P' <= 8. A wide
// flush word shifts to the narrow flush word, and a word whose leading
// mantissa bits are all 0 at dexp_max decodes to 0 in the narrow
// geometry, as the JAX decoder does.
//
// Paged (tables != nullptr): the cache is a pool of physical blocks of
// block_l slots shared by every row; tile t of row b reads physical block
// tables[b * nb + t] and masks on logical slots (global attention, no
// window). The body is the contiguous kernel's with block_l = the pool
// block, so it is bit-equal to the contiguous kernel over the gathered
// cache. Trailing logical blocks point at the trash block 0; their slots
// lie past pos, so they are skipped like any tile no slot may see.
#include "sfp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kMaxDPerThread = 2;  // hd <= 512

__device__ __forceinline__ bool slot_valid(int slot, int pos, int L,
                                           int window) {
  if (slot >= L) return false;
  if (window <= 0) return slot <= pos;
  int r = (pos - slot) % L;
  if (r < 0) r += L;  // floor mod
  const int kpos = pos - r;
  return kpos >= 0 && kpos <= pos && kpos > pos - window;
}

constexpr int kMaxPlanes = 16;

// Dense branch of the staging: the words of head h's features in the BL
// slots from cache row row0 on, rebuilt from the leading P of the P_store
// bit planes of each group (planes P_store-P .. P_store-1).
template <typename W>
__device__ __forceinline__ void stage_dense_words(
    const uint8_t* __restrict__ kp, const uint8_t* __restrict__ vp, W* kt,
    W* vt, size_t row0, int h, int hd, int cols, int BL, int P, int P_store,
    int lane, int warp) {
  const int c0 = (h * hd) >> 5, c1 = (h * hd + hd - 1) >> 5;
  const int nch = c1 - c0 + 1;
  for (int task = warp; task < BL * nch; task += kWarps) {
    const int l = task / nch, c = c0 + task % nch;
    const size_t off = (row0 + l) * cols
                       + (size_t)((c >> 2) * P_store + P_store - P) * 16
                       + (c & 3) * 4;
    uint32_t ku = 0u, vu = 0u;
    if (lane < P) {
      ku = *reinterpret_cast<const uint32_t*>(kp + off + lane * 16);
      vu = *reinterpret_cast<const uint32_t*>(vp + off + lane * 16);
    }
    uint32_t kw = 0u, vw = 0u;
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      if (p >= P) break;
      kw |= ((__shfl_sync(0xffffffffu, ku, p) >> lane) & 1u) << p;
      vw |= ((__shfl_sync(0xffffffffu, vu, p) >> lane) & 1u) << p;
    }
    const int d = c * 32 + lane - h * hd;
    if (d >= 0 && d < hd) {
      kt[l * hd + d] = (W)kw;
      vt[l * hd + d] = (W)vw;
    }
  }
}

template <typename W, bool DENSE>
__global__ void __launch_bounds__(kThreads)
packed_flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                           const void* __restrict__ kp_raw,
                           const uint8_t* __restrict__ kb,
                           const void* __restrict__ vp_raw,
                           const uint8_t* __restrict__ vb,
                           const int* __restrict__ pos_arr,
                           const int* __restrict__ tables,
                           __nv_bfloat16* __restrict__ out, int L, int H,
                           int KH, int hd, int G, int cols, int BL,
                           int window, SfpFields f, int drop, int P_store,
                           float softcap, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int rep = H / KH;
  const int D = G * SFP_GROUP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr[b];

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [rep][hd]
  float* st = qs + rep * hd;                           // [rep][BL]
  float* ms = st + rep * BL;                           // [kMaxRep]
  float* ls = ms + kMaxRep;
  float* als = ls + kMaxRep;
  W* kt = reinterpret_cast<W*>(als + kMaxRep);         // [BL][hd]
  W* vt = kt + BL * hd;                                // [BL][hd]
  uint8_t* kbt = reinterpret_cast<uint8_t*>(vt + BL * hd);  // [BL][G]
  uint8_t* vbt = kbt + BL * G;

  for (int i = tid; i < rep * hd; i += kThreads)
    qs[i] = __bfloat162float(q[((size_t)b * H + h * rep) * hd + i]);
  if (tid < kMaxRep) { ms[tid] = SFP_NEG_INF; ls[tid] = 0.f; als[tid] = 1.f; }

  float acc[kMaxRep][kMaxDPerThread];
#pragma unroll
  for (int g = 0; g < kMaxRep; ++g)
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) acc[g][j] = 0.f;

  const int row_words = hd * (int)sizeof(W) / 4;  // uint32 per head row
  for (int t = 0; t * BL < L; ++t) {
    const int s0 = t * BL;
    // First cache row of this tile: contiguous rows of batch row b, or
    // the physical pool block the row's table names.
    const size_t row0 = tables != nullptr
        ? (size_t)tables[(size_t)b * (L / BL) + t] * BL
        : (size_t)b * L + s0;
    int any = 0;
    for (int l = tid; l < BL; l += kThreads) any |= slot_valid(s0 + l, pos, L, window);
    if (!__syncthreads_or(any)) continue;  // barrier: last tile's readers done

    if constexpr (DENSE) {
      stage_dense_words<W>(static_cast<const uint8_t*>(kp_raw),
                           static_cast<const uint8_t*>(vp_raw), kt, vt, row0,
                           h, hd, cols, BL, f.payload_bits, P_store, lane,
                           warp);
    } else {
      const W* kp = static_cast<const W*>(kp_raw);
      const W* vp = static_cast<const W*>(vp_raw);
      for (int idx = tid; idx < BL * row_words; idx += kThreads) {
        const int l = idx / row_words, c = idx % row_words;
        const size_t off = (row0 + l) * D + (size_t)h * hd;
        reinterpret_cast<uint32_t*>(kt + l * hd)[c] =
            reinterpret_cast<const uint32_t*>(kp + off)[c];
        reinterpret_cast<uint32_t*>(vt + l * hd)[c] =
            reinterpret_cast<const uint32_t*>(vp + off)[c];
      }
    }
    for (int idx = tid; idx < BL * G; idx += kThreads) {
      const size_t off = row0 * G + idx;
      kbt[idx] = kb[off];
      vbt[idx] = vb[off];
    }
    __syncthreads();

    // Scores: one warp per slot, lanes over 4-feature chunks of the head.
    for (int l = warp; l < BL; l += kWarps) {
      float part[kMaxRep];
#pragma unroll
      for (int g = 0; g < kMaxRep; ++g) part[g] = 0.f;
      for (int d4 = lane * 4; d4 < hd; d4 += 128) {
        const int base = kbt[l * G + ((h * hd + d4) >> 7)];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = sfp_decode_word(
              (uint32_t)kt[l * hd + d4 + e] >> drop, base, f);
#pragma unroll
          for (int g = 0; g < kMaxRep; ++g)
            if (g < rep) part[g] = fmaf(qs[g * hd + d4 + e], kv, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxRep; ++g) {
        if (g >= rep) break;
        float x = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == 0) st[g * BL + l] = x;
      }
    }
    __syncthreads();

    // Online softmax: one warp per query head of the group.
    if (warp < rep) {
      const int g = warp;
      float mcur = SFP_NEG_INF;
      for (int l = lane; l < BL; l += 32) {
        float x = st[g * BL + l] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = slot_valid(s0 + l, pos, L, window) ? x : SFP_NEG_INF;
        st[g * BL + l] = x;
        mcur = fmaxf(mcur, x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, o));
      const float m_new = fmaxf(ms[g], mcur);
      float sum = 0.f;
      for (int l = lane; l < BL; l += 32) {
        const float p = expf(st[g * BL + l] - m_new);
        st[g * BL + l] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(ms[g] - m_new);
        ls[g] = alpha * ls[g] + sum;
        ms[g] = m_new;
        als[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v, one thread per feature of the head.
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d >= hd) break;
      const int gi = (h * hd + d) >> 7;
#pragma unroll
      for (int g = 0; g < kMaxRep; ++g)
        if (g < rep) acc[g][j] *= als[g];
      for (int l = 0; l < BL; ++l) {
        const float vv = sfp_decode_word((uint32_t)vt[l * hd + d] >> drop,
                                         vbt[l * G + gi], f);
#pragma unroll
        for (int g = 0; g < kMaxRep; ++g)
          if (g < rep) acc[g][j] = fmaf(st[g * BL + l], vv, acc[g][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kMaxDPerThread; ++j) {
    const int d = tid + j * kThreads;
    if (d >= hd) break;
#pragma unroll
    for (int g = 0; g < kMaxRep; ++g) {
      if (g >= rep) break;
      out[((size_t)b * H + h * rep + g) * hd + d] =
          __float2bfloat16(acc[g][j] / fmaxf(ls[g], 1e-30f));
    }
  }
}

template <typename W, bool DENSE>
int launch(const void* q, const void* kp, const void* kb, const void* vp,
           const void* vb, const void* pos, const void* tables, void* out,
           int B, int L, int H, int KH, int hd, int G, int cols, int BL,
           int window, SfpFields f, int drop, int P_store, float softcap,
           float scale, cudaStream_t stream) {
  const int rep = H / KH;
  const size_t smem = (size_t)(rep * hd + rep * BL + 3 * kMaxRep) * 4
                      + 2 * (size_t)BL * hd * sizeof(W) + 2 * (size_t)BL * G;
  cudaError_t err = cudaFuncSetAttribute(
      packed_flash_decode_kernel<W, DENSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KH);
  packed_flash_decode_kernel<W, DENSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kp,
      static_cast<const uint8_t*>(kb), vp, static_cast<const uint8_t*>(vb),
      static_cast<const int*>(pos), static_cast<const int*>(tables),
      static_cast<__nv_bfloat16*>(out), L, H, KH, hd, G, cols, BL, window, f,
      drop, P_store, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Contiguous cache: tables == nullptr, L slots per row, payload (B, L,
// cols). Paged pool: tables (B, nb) int32, L = nb * block_l logical slots,
// payload (P_blocks, block_l, cols), window -1. prefix_planes -1 (or the
// payload width) reads full width.
extern "C" int packed_flash_decode_launch(
    const void* q, const void* kp, const void* kb, const void* vp,
    const void* vb, const void* pos, const void* tables, void* out, int B,
    int L, int H, int KH, int hd, int G, int block_l, int window,
    int man_keep, int dexp_bits, int payload_bits, int dense,
    int prefix_planes, float softcap, float scale, void* stream) {
  if (B == 0 || KH == 0) return 0;
  if (H % KH != 0 || H / KH > kMaxRep || hd > kThreads * kMaxDPerThread
      || hd % 4 != 0 || block_l <= 0 || L % block_l != 0
      || (tables != nullptr && window > 0))
    return (int)cudaErrorInvalidValue;
  const int P = payload_bits;
  const int Pr = prefix_planes < 0 ? P : prefix_planes;
  if (Pr < dexp_bits + 2 || Pr > P || man_keep - (P - Pr) < 0)
    return (int)cudaErrorInvalidValue;
  // The geometry the kernel decodes: the leading Pr bits of each word.
  const SfpFields f{man_keep - (P - Pr), dexp_bits, Pr};
  auto s = static_cast<cudaStream_t>(stream);
  const int D = G * SFP_GROUP;
  if (dense) {
    if (P < 3 || P > kMaxPlanes || 1 + dexp_bits + man_keep != P)
      return (int)cudaErrorInvalidValue;
    const int cols = G * P * 16;
    if (Pr <= 8)
      return launch<uint8_t, true>(q, kp, kb, vp, vb, pos, tables, out, B, L,
                                   H, KH, hd, G, cols, block_l, window, f, 0,
                                   P, softcap, scale, s);
    return launch<uint16_t, true>(q, kp, kb, vp, vb, pos, tables, out, B, L,
                                  H, KH, hd, G, cols, block_l, window, f, 0,
                                  P, softcap, scale, s);
  }
  if (P == 8)
    return launch<uint8_t, false>(q, kp, kb, vp, vb, pos, tables, out, B, L,
                                  H, KH, hd, G, D, block_l, window, f, P - Pr,
                                  P, softcap, scale, s);
  if (P == 16)
    return launch<uint16_t, false>(q, kp, kb, vp, vb, pos, tables, out, B, L,
                                   H, KH, hd, G, D, block_l, window, f,
                                   P - Pr, P, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
