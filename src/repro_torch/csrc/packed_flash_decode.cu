// Fused decompress-attend decode over an SFP-packed KV cache, contiguous
// or paged.
//
// Replaces the TPU kernels src/repro/kernels/packed_flash_decode.py:
// packed_flash_decode (_decode_kernel) and paged_flash_decode
// (_paged_kernel), each with its fixed-lane word branch, its dense
// bit-plane branch and its prefix_planes draft read mode. One query token
// per batch row attends an L-slot cache stored as payload words (B, L,
// KH*hd) uint8/uint16, or as dense bit planes (B, L, G*P*16) uint8 ordered
// (group, plane, 16 bytes) per slot, plus one uint8 base per 128-lane
// group (B, L, G = KH*hd/128). Groups run along the flattened KH*hd axis
// and may straddle heads (hd = 288: 9 groups over 4 heads), and a head may
// start 16 lanes past a 32-lane boundary (hd = 240 or 144: every odd
// head). Per-row decode
// positions; a window > 0 means an L-slot ring buffer (floor mod, as the
// JAX mask). The function is the JAX kernel's: per block_l-slot tile,
// scores in f32, softcap, -1e30 on masked slots, softmax, p . v.
//
// Bound on this card: memory, (D * P' / 8 + D / 128) bytes per live slot
// for K and again for V (P' = the bits read). Design:
//
// 1. Split-KV. The grid is (split, KV head, batch row); split s is slots
//    [s * split_l, (s + 1) * split_l), split_l a divisor of the tile (64
//    of 128, kernels/packed_flash_decode.split_plan): a function of the
//    slot index and the tile alone (never of B, the other rows or the
//    card), so a row's output is bit-equal alone or inside any batch. Each
//    CTA runs its split's softmax from scratch and writes (m, l,
//    acc[rep][hd]) in f32 to scratch the wrapper allocates; the last CTA
//    of a (row, KV head) to take an integer ticket merges the splits in
//    split order (no floating-point atomics: deterministic). A split with
//    no visible slot writes m = -1e30, l = 0 and gets weight exactly 0; a
//    visible split skips its 32-slot sub-tiles that no slot may see,
//    whose p would be exactly 0. Paged: split s of row b reads its tile's
//    physical block tables[b, s * split_l / block_l], so paged is
//    bit-equal to the contiguous kernel over the gathered cache.
// 2. Asynchronous staging. The CTA walks its visible sub-tiles twice (K
//    for the scores, then V for p . v) through a ring of kStages shared
//    buffers filled by 16-byte cp.async copies of the head's K or V rows,
//    kStages - 1 sub-tiles in flight while one is computed. The split's
//    group bases come in with the first sub-tile. Rows are padded in
//    shared memory to an odd count of 16-byte units (no bank conflicts on
//    16-byte reads); the wrapper raises on rows that are not 16-byte
//    aligned.
// 3. Dense planes by a register SWAR transpose (transpose8 in swar.cuh:
//    the JAX package's _reg_transpose8, Hacker's Delight delta-swaps): a
//    32-lane chunk C of one slot (on the absolute grid of the flattened
//    axis, item 4) is uint32 C % 4 of each plane row of group C / 4; one
//    thread turns its P' (<= 8) plane words into 32
//    payload bytes with 12 masked swaps, and P' > 8 takes a second transpose for the high bytes. A
//    draft loads only planes P - P' .. P - 1 as rows 0 .. P' - 1, which
//    are the P'-bit words of the narrow geometry: fewer bytes read.
// 4. Balanced math: chunks of 32 lanes counted on the absolute grid of the
//    flattened KH*hd axis, so that each lies in one 128-lane group (one
//    base) and one uint32 of each plane row. A head starting o = (h * hd)
//    % 32 lanes into its first chunk (0, or 16 when hd = 16 mod 32)
//    covers nch = ceil(hd / 32) chunks, whatever o is; with o = 16 its
//    first chunk's low half is the previous head's, with hd = 16 (mod 32)
//    and o = 0 its last chunk's high half is the next head's. 32 nch
//    threads (hd % 16 == 0), warp c owning chunk c of the head. Scores:
//    lane l decodes slot l's words of its chunk that belong to the head
//    (16-byte word runs: a half chunk is whole runs) against q read as a
//    warp broadcast; partial sums over chunks are added in chunk order.
//    p . v: thread d < hd owns feature d and walks the sub-tile's slots.
//    Every K and V element is decoded once per CTA,
//    by one multiply where the group's base allows it (fast_decode, exact)
//    and by sfp_decode_word elsewhere. Register arrays are sized by rep
//    rounded up to a power of two (a template parameter, up to 16); the
//    16-wide instances run as a kernel of their own with a larger
//    register budget.
//
// What bounds it in practice (H100, PERF.md): the decode arithmetic and
// the per-CTA latency chain, not bytes: ~35-45 us at the smoke shapes
// against byte bounds of 2.2-3.0 us.
//
// Shard view (lse != nullptr): the rank of a mesh whose cache holds the
// slots [slot0, slot0 + L) of an L_global-slot cache (its sequence shard
// over `model`) reads them alone. The validity mask takes the global slot
// slot0 + l against L_global (a LOCAL ring's slot -> position), the splits
// are split_l slots from the shard's first, the last one partial where
// split_l does not divide L (masked by slot; the cache is not padded), and
// the merge writes the normalized f32 o (B, H, hd) and the log-sum-exp
// (B, H) of the visible scores (-inf where none) instead of the bf16 o:
// the ranks' partials are combined over `model` outside the kernel
// (sharding.lse_combine). A whole cache read this way (slot0 0, L_global
// L) gives the bf16 output's f32 value before its rounding.
//
// Draft read (prefix_planes P' < P): only the leading P' bits of each word
// are decoded, as the narrow geometry (man_keep - (P - P') mantissa bits;
// ref.prefix_fields). Fixed-lane words are staged as stored and shifted
// right by P - P' before the decode (same bytes read). A wide flush word
// shifts to the narrow flush word, and a word whose leading mantissa bits
// are all 0 at dexp_max decodes to 0 in the narrow geometry, as the JAX
// decoder does.
#include <type_traits>

#include "sfp_common.cuh"
#include "swar.cuh"

namespace {

constexpr int kSub = 32;       // slots per sub-tile: one per lane
constexpr int kStages = 4;     // shared ring depth: 3 sub-tiles in flight
constexpr int kMaxRep = 16;   // query heads a KV head
constexpr int kMaxHd = 512;    // features a head (threads a CTA)
constexpr int kMaxSub = 32;    // sub-tiles a split (block_l <= 1024)
constexpr int kMaxPlanes = 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ bool slot_valid(int slot, int pos, int L,
                                           int window) {
  if (slot >= L) return false;
  if (window <= 0) return slot <= pos;
  int r = (pos - slot) % L;
  if (r < 0) r += L;  // floor mod
  const int kpos = pos - r;
  return kpos >= 0 && kpos <= pos && kpos > pos - window;
}

// Index of the k-th set bit of m (k counts from 0).
__device__ __forceinline__ int nth_set(unsigned m, int k) {
  for (; k > 0; --k) m &= m - 1u;
  return __ffs(m) - 1;
}

// After transpose8, byte i of y[j] is the payload byte of lane 8i + j.
// Interleave into lane order: out[2i] holds lanes 8i..8i+3, out[2i + 1]
// lanes 8i+4..8i+7.
__device__ __forceinline__ void lane_order(const uint32_t y[8],
                                           uint32_t out[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t* z = y + 4 * half;
    const uint32_t a01 = __byte_perm(z[0], z[1], 0x5140);  // bytes 0,1
    const uint32_t b01 = __byte_perm(z[0], z[1], 0x7362);  // bytes 2,3
    const uint32_t a23 = __byte_perm(z[2], z[3], 0x5140);
    const uint32_t b23 = __byte_perm(z[2], z[3], 0x7362);
    out[0 + half] = __byte_perm(a01, a23, 0x5410);
    out[2 + half] = __byte_perm(a01, a23, 0x7632);
    out[4 + half] = __byte_perm(b01, b23, 0x5410);
    out[6 + half] = __byte_perm(b01, b23, 0x7632);
  }
}

// The exact decode as one multiply. A word (sign, dexp, man) of a group
// whose base satisfies dmax < base <= 254 is never clamped, and its value
// +-1.man * 2^(base - dexp - 127) is F * scale with F = +-1.man *
// 2^(dmax - dexp) (built from the word's bits, dexp complemented by an
// xor) and scale = 2^(base - dmax - 127), both normal, so the product is
// exact. inv == 0 is the flush code (dexp = dmax, man = 0), which
// decodes to +0. The mask keeps the (dexp, man) fields and clears the
// bits below the mantissa (sfp16 over bf16 has 3) and those a draft
// drops, so a fixed-lane word is read in the narrow geometry unshifted.
struct FastDecode {
  uint32_t flip;  // dmax at the dexp field: complements dexp
  uint32_t mask;  // the (dexp, man) bits read
  int sh;         // moves dexp to bit 23
  int sgn;        // moves the sign to bit 31
  int dmax;
};

// f is the geometry decoded; the stored word is drop bits wider.
__device__ __forceinline__ FastDecode fast_fields(SfpFields f, int drop) {
  const int dpos = f.dexp_shift() + drop;  // dexp field of the stored word
  const int low = f.man_shift() + drop;    // lowest mantissa bit read
  FastDecode d;
  d.dmax = f.dexp_max();
  d.flip = (uint32_t)d.dmax << dpos;
  d.mask = ((1u << (f.dexp_bits + dpos)) - 1u) & ~((1u << low) - 1u);
  d.sh = 23 - dpos;
  d.sgn = 32 - (f.payload_bits + drop);
  return d;
}

// scale = 2^(base - dmax - 127), or 0 where the fast decode does not hold.
__device__ __forceinline__ float fast_scale(int base, int dmax) {
  return base > dmax && base <= 254
      ? __uint_as_float((uint32_t)(base - dmax) << 23) : 0.f;
}

__device__ __forceinline__ float fast_decode(uint32_t w, float scale,
                                             const FastDecode& d) {
  const uint32_t inv = (w ^ d.flip) & d.mask;
  const float F = __uint_as_float(((inv << d.sh) + (127u << 23))
                                  | ((w << d.sgn) & 0x80000000u));
  return inv == 0u ? 0.f : F * scale;
}

// One word: the fast decode, or the exact one (any base).
template <bool FAST>
__device__ __forceinline__ float decode_word(uint32_t w, float scale, int base,
                                             const FastDecode& fd,
                                             const SfpFields& f, int drop) {
  if constexpr (FAST) return fast_decode(w, scale, fd);
  else return sfp_decode_word(w >> drop, base, f);
}

struct DecodeArgs {
  const __nv_bfloat16* q;
  const uint8_t* kp;  // payload bytes
  const uint8_t* kb;
  const uint8_t* vp;
  const uint8_t* vb;
  const int* pos;
  const int* tables;  // nullptr: contiguous cache
  float* part;        // scratch: m, l [B*KH*nsplit*rep], acc [..][hd]
  int* tickets;       // [B*KH], zero between launches
  __nv_bfloat16* out;
  float* out_f32;     // shard view: f32 o (B, H, hd), else nullptr
  float* lse;         // shard view: log-sum-exp (B, H), else nullptr
  int B, L, H, KH, hd, G, BL, window;
  int slot0, Lg;      // the first slot's global index, the global length
  int SL, nsplit;     // slots a split (divides BL), splits a row
  int row_bytes;      // payload bytes per cache row
  SfpFields f;        // the geometry decoded (the leading Pr bits)
  int drop;           // words: P - Pr, shifted out before the decode
  int P_store, Pr;    // dense: stored planes, planes read
  float softcap, scale;
};

// Shared memory layout, one function for the launcher and the kernel.
struct Layout {
  int stage_stride;   // bytes per slot row of a stage
  int word_stride;    // bytes per slot row of the dense word tile
  int stage, words, qs, st, red, ml, flags, scales, merge, bases, total;
};

__host__ __device__ inline int odd_units(int bytes) {
  int u = (bytes + 15) / 16;
  return 16 * (u | 1);
}

__host__ __device__ inline Layout make_layout(const DecodeArgs& a,
                                              bool dense, int wbytes) {
  Layout y;
  const int rep = a.H / a.KH;
  int ngr = 1;  // groups a head touches, at most
  for (int h = 0; h < a.KH; ++h)
    ngr = max(ngr, ((h * a.hd + a.hd - 1) >> 7) - ((h * a.hd) >> 7) + 1);
  const int nch = (a.hd + 31) >> 5;  // 32-lane chunks a head covers
  // Dense: the word tile holds the head's nch whole chunks.
  y.word_stride = odd_units((dense ? 32 * nch : a.hd) * wbytes);
  y.stage_stride = dense ? odd_units(ngr * a.Pr * 16) : y.word_stride;
  int off = 0;
  y.stage = off; off += kStages * kSub * y.stage_stride;
  y.words = off; off += dense ? kSub * y.word_stride : 0;
  y.qs = off;    off += 4 * rep * a.hd;
  y.st = off;    off += 4 * ((rep * a.SL + 3) / 4 * 4);
  y.red = off;   off += 4 * nch * rep * kSub;
  y.ml = off;    off += 4 * 2 * kMaxRep;
  y.flags = off; off += 4 * (kMaxSub + 4);
  y.scales = off; off += 4 * 2 * ((a.SL * a.G + 3) / 4 * 4);
  y.merge = off; off += 4 * ((3 * rep * a.nsplit + kMaxRep + 3) / 4 * 4);
  y.bases = off; off += 2 * (((a.SL * a.G + 31) / 16) * 16);
  y.total = off;
  return y;
}

// After a CTA has written its partials: the last CTA of its (row, KV
// head) to take a ticket merges the row's splits in split order, out =
// sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - max m); a split
// with l = 0 saw no slot and weighs 0 (its acc was never written). No
// floating-point atomics: the result does not depend on which CTA is last.
__device__ void ticket_merge(const DecodeArgs& a, int b, int h,
                             float* buf, int* last) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int rep = a.H / a.KH, ns = a.nsplit, hd = a.hd;
  int* ticket = a.tickets + (size_t)b * a.KH + h;
  __threadfence();  // this CTA's partials before its ticket
  __syncthreads();
  if (tid == 0) *last = atomicAdd(ticket, 1) == ns - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid == 0) *ticket = 0;  // ready for the next launch

  const size_t B_KH_S = (size_t)a.B * a.KH * ns;
  const size_t p0 = ((size_t)b * a.KH + h) * ns;
  const float* part_m = a.part;
  const float* part_l = a.part + B_KH_S * rep;
  const float* part_acc = a.part + 2 * B_KH_S * rep;
  float* mm = buf;                // [rep][ns]
  float* ll = mm + rep * ns;
  float* ww = ll + rep * ns;
  float* MM = ww + rep * ns;      // [rep]
  for (int t = tid; t < rep * ns; t += nthr) {
    const int sp = t / rep, g = t - sp * rep;
    mm[g * ns + sp] = __ldcg(part_m + (p0 + sp) * rep + g);
    ll[g * ns + sp] = __ldcg(part_l + (p0 + sp) * rep + g);
  }
  __syncthreads();
  for (int g = warp; g < rep; g += nwarps) {
    float mx = SFP_NEG_INF;
    for (int sp = lane; sp < ns; sp += 32)
      if (ll[g * ns + sp] > 0.f) mx = fmaxf(mx, mm[g * ns + sp]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) MM[g] = mx;
  }
  __syncthreads();
  for (int t = tid; t < rep * ns; t += nthr)
    ww[t] = ll[t] > 0.f ? expf(mm[t] - MM[t / ns]) : 0.f;
  __syncthreads();
  // The partials in batches of loads with no predicate between them, so
  // each batch is one round trip: 16 at a time, then 4 at a time with the
  // addresses past the last split clamped and their terms dropped (a
  // wider batch spills under the register cap). Summed in split order.
  const size_t stride = (size_t)rep * hd;
  if (tid >= hd) return;  // a thread a feature
  for (int g = 0; g < rep; ++g) {
    const float* pa = part_acc + (p0 * rep + g) * hd + tid;
    const float* wg = ww + g * ns;
    const float* lg = ll + g * ns;
    float l = 0.f, acc = 0.f;
    auto add = [&](int sp, float x) {  // w == 0 adds nothing
      const float w = wg[sp];
      l += w != 0.f ? w * lg[sp] : 0.f;
      acc += w != 0.f ? w * x : 0.f;
    };
    int s0 = 0;
    for (; s0 + 16 <= ns; s0 += 16) {
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = __ldcg(pa + (s0 + j) * stride);
#pragma unroll
      for (int j = 0; j < 16; ++j) add(s0 + j, x[j]);
    }
    for (; s0 < ns; s0 += 4) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)  // an unwritten acc is in bounds
        x[j] = __ldcg(pa + min(s0 + j, ns - 1) * stride);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < ns) add(s0 + j, x[j]);
    }
    const float o = acc / fmaxf(l, 1e-30f);
    const size_t oi = ((size_t)b * a.H + h * rep + g) * hd + tid;
    if (a.lse == nullptr) {
      a.out[oi] = __float2bfloat16(o);
      continue;
    }
    a.out_f32[oi] = o;
    if (tid == 0)
      a.lse[(size_t)b * a.H + h * rep + g] =
          l > 0.f ? MM[g] + logf(l) : -__int_as_float(0x7f800000);
  }
}

template <typename W, bool DENSE, int REP>
__device__ __forceinline__ void decode_split(const DecodeArgs a) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, c = tid >> 5;
  const int hd = a.hd, nthr = blockDim.x, nch = nthr >> 5;
  const int rep = a.H / a.KH, SL = a.SL, G = a.G;  // rep <= REP
  const int nsub = (SL + kSub - 1) / kSub;
  const int pos = a.pos[b];
  const int s0 = s * SL;
  const int SLs = min(SL, a.L - s0);  // a shard's last split may be partial
  const int gs0 = a.slot0 + s0;       // the split's first global slot
  const Layout lay = make_layout(a, DENSE, (int)sizeof(W));

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + lay.qs);    // [rep][hd]
  float* st = reinterpret_cast<float*>(smem + lay.st);    // [rep][SL]
  float* red = reinterpret_cast<float*>(smem + lay.red);  // [nch][rep][32]
  float* ms = reinterpret_cast<float*>(smem + lay.ml);
  float* ls = ms + kMaxRep;
  int* flags = reinterpret_cast<int*>(smem + lay.flags);
  float* ksc = reinterpret_cast<float*>(smem + lay.scales);  // [SL][G]
  float* vsc = ksc + (SL * G + 3) / 4 * 4;
  float* mbuf = reinterpret_cast<float*>(smem + lay.merge);
  int* last = flags + kMaxSub;

  // Which 32-slot sub-tiles may any slot see: one warp a sub-tile.
  for (int j = c; j < nsub; j += nch) {
    const int l = j * kSub + lane;
    const bool v = l < SLs && slot_valid(gs0 + l, pos, a.Lg, a.window);
    const unsigned any = __ballot_sync(0xffffffffu, v);
    if (lane == 0) flags[j] = any != 0u;
  }
  __syncthreads();
  unsigned vis = 0u;
  for (int j = 0; j < nsub; ++j) vis |= (unsigned)(flags[j] != 0) << j;

  const size_t B_KH_S = (size_t)a.B * a.KH * a.nsplit;
  float* part_m = a.part;
  float* part_l = a.part + B_KH_S * rep;
  float* part_acc = a.part + 2 * B_KH_S * rep;
  const size_t pidx = ((size_t)b * a.KH + h) * a.nsplit + s;
  if (vis == 0u) {  // no slot of this split is visible: weight 0
    if (tid < rep) {
      part_m[pidx * rep + tid] = SFP_NEG_INF;
      part_l[pidx * rep + tid] = 0.f;
    }
    ticket_merge(a, b, h, mbuf, last);
    return;
  }
  const int nv = __popc(vis);
  const int nchunks = 2 * nv;  // K sub-tiles, then V sub-tiles

  // First cache row of this split: the row's own slots, or its place in
  // the physical pool block the row's table names for its tile.
  const int BL = a.BL;
  const size_t row0 = a.tables != nullptr
      ? (size_t)a.tables[(size_t)b * (a.L / BL) + s0 / BL] * BL + s0 % BL
      : (size_t)b * a.L + s0;
  const int g0 = (h * hd) >> 7;  // first group of the head
  const int C0 = (h * hd) >> 5;  // first chunk of the head
  const int o = (h * hd) & 31;   // the head's first lane in chunk C0
  // Tile word of feature 0: the dense word tile starts at chunk C0, the
  // staged words at the head.
  const int woff = DENSE ? o : 0;

  // The split's bases (SL * G contiguous bytes) in 16-byte copies from
  // the aligned byte at or below the first one.
  const size_t bfirst = row0 * G, bend = bfirst + (size_t)SLs * G;
  const size_t balign = bfirst & ~(size_t)15;
  const int boff = (int)(bfirst - balign);
  const int bunits = (int)((bend - balign + 15) / 16);
  const int bstride = ((SL * G + 31) / 16) * 16;
  uint8_t* kbt = smem + lay.bases;
  uint8_t* vbt = kbt + bstride;
  for (int u = tid; u < 2 * bunits; u += nthr) {
    const int uu = u < bunits ? u : u - bunits;
    const size_t src = balign + 16 * (size_t)uu;
    const int n = bend - src < 16 ? (int)(bend - src) : 16;
    cp_async16((u < bunits ? kbt : vbt) + 16 * uu,
               (u < bunits ? a.kb : a.vb) + src, n);
  }
  const uint8_t* kbase = kbt + boff;  // [SL][G]
  const uint8_t* vbase = vbt + boff;

  auto stage_chunk = [&](int i) {
    const bool is_v = i >= nv;
    const int l0 = nth_set(vis, is_v ? i - nv : i) * kSub;
    const int n = min(kSub, SLs - l0);
    const uint8_t* src = (is_v ? a.vp : a.kp)
                         + (row0 + l0) * (size_t)a.row_bytes;
    unsigned char* dst = smem + lay.stage + (i % kStages) * kSub
                         * lay.stage_stride;
    if constexpr (DENSE) {
      // Per slot: the head's ngr groups x Pr plane rows (the last Pr).
      const int ngr = ((h * hd + hd - 1) >> 7) - g0 + 1;
      const int U = ngr * a.Pr;
      for (int t = tid; t < n * U; t += nthr) {
        const int l = t / U, u = t - l * U;
        const int gi = u / a.Pr, p = u - gi * a.Pr;
        cp_async16(dst + l * lay.stage_stride + 16 * u,
                   src + (size_t)l * a.row_bytes
                       + ((g0 + gi) * a.P_store + a.P_store - a.Pr + p) * 16,
                   16);
      }
    } else {
      const int U = hd * (int)sizeof(W) / 16;
      const size_t head = (size_t)h * hd * sizeof(W);
      for (int t = tid; t < n * U; t += nthr) {
        const int l = t / U, u = t - l * U;
        cp_async16(dst + l * lay.stage_stride + 16 * u,
                   src + (size_t)l * a.row_bytes + head + 16 * u, 16);
      }
    }
  };

  stage_chunk(0);
  cp_async_commit();  // group 0: the bases and sub-tile 0
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < nchunks) stage_chunk(i);
    cp_async_commit();
  }
  for (int i = tid; i < rep * hd; i += nthr)
    qs[i] = __bfloat162float(a.q[((size_t)b * a.H + h * rep) * hd + i]);

  float acc[REP];
#pragma unroll
  for (int g = 0; g < REP; ++g) acc[g] = 0.f;
  const int wstride = DENSE ? lay.word_stride : lay.stage_stride;
  const SfpFields f = a.f;
  const FastDecode fd = fast_fields(f, a.drop);

  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // sub-tile i landed; sub-tile i - 1 fully read
    if (i + kStages - 1 < nchunks) stage_chunk(i + kStages - 1);
    cp_async_commit();
    if (i == 0) {  // the bases landed with sub-tile 0: their scales
      for (int t = tid; t < 2 * SL * G; t += nthr) {
        const bool v = t >= SL * G;
        const int j = v ? t - SL * G : t;
        (v ? vsc : ksc)[j] = fast_scale((v ? vbase : kbase)[j], fd.dmax);
      }
      __syncthreads();
    }

    const bool is_v = i >= nv;
    const int l0 = nth_set(vis, is_v ? i - nv : i) * kSub;
    const int n = min(kSub, SLs - l0);
    const unsigned char* stage = smem + lay.stage + (i % kStages) * kSub
                                 * lay.stage_stride;
    const unsigned char* wt = stage;
    if constexpr (DENSE) {
      // Lane l rebuilds slot l's 32 words of chunk c from its plane rows.
      unsigned char* wtile = smem + lay.words;
      if (lane < n) {
        const int C = C0 + c;  // flat chunk index
        const uint32_t* rows = reinterpret_cast<const uint32_t*>(
            stage + lane * lay.stage_stride + ((C >> 2) - g0) * a.Pr * 16)
            + (C & 3);
        uint32_t x[8], lo[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) x[p] = p < a.Pr ? rows[4 * p] : 0u;
        transpose8(x);
        lane_order(x, lo);
        uint4* dst = reinterpret_cast<uint4*>(wtile + lane * lay.word_stride
                                              + c * 32 * sizeof(W));
        if constexpr (sizeof(W) == 1) {
          dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        } else {
          uint32_t hi[8];
#pragma unroll
          for (int p = 0; p < 8; ++p)
            x[p] = p + 8 < a.Pr ? rows[4 * (p + 8)] : 0u;
          transpose8(x);
          lane_order(x, hi);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dst[k] = make_uint4(__byte_perm(lo[2 * k], hi[2 * k], 0x5140),
                                __byte_perm(lo[2 * k], hi[2 * k], 0x7362),
                                __byte_perm(lo[2 * k + 1], hi[2 * k + 1],
                                            0x5140),
                                __byte_perm(lo[2 * k + 1], hi[2 * k + 1],
                                            0x7362));
        }
      }
      __syncthreads();
      wt = wtile;
    }

    if (!is_v) {
      // Scores: lane l takes slot l, warp c the head's chunk c: the uint4s
      // of words [k0w, k1w) of it belong to the head.
      if (lane < n) {
        constexpr int NV = 2 * sizeof(W);   // uint4s per 32 words
        constexpr int PER = 32 / NV;        // words per uint4
        const int f0 = 32 * c - o;          // the chunk's first feature
        const int k0w = max(0, -f0) / PER;
        const int k1w = min(32, hd - f0) / PER;
        const uint4* src = reinterpret_cast<const uint4*>(
            wt + lane * wstride + (f0 + woff) * (int)sizeof(W));
        const int bi = (l0 + lane) * G + ((C0 + c) >> 2);
        const float scale = ksc[bi];
        const int base = kbase[bi];
        const float* qc = qs + f0;
        float part[REP];
#pragma unroll
        for (int g = 0; g < REP; ++g) part[g] = 0.f;
        // One uint4 of words at a time: 16 (or 8) words in registers. The
        // decode is chosen once for the slot's group (fast unless the base
        // is small or 255).
        auto scores = [&](auto fast) {
          constexpr bool FAST = decltype(fast)::value;
#pragma unroll 1
          for (int k = k0w; k < k1w; ++k) {
            const uint4 t = src[k];
            const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int e4 = 0; e4 < PER; e4 += 4) {
              float kv[4];
#pragma unroll
              for (int e = e4; e < e4 + 4; ++e) {
                uint32_t w;
                if constexpr (sizeof(W) == 1)
                  w = (u[e >> 2] >> (8 * (e & 3))) & 0xFFu;
                else
                  w = (u[e >> 1] >> (16 * (e & 1))) & 0xFFFFu;
                kv[e - e4] = decode_word<FAST>(w, scale, base, fd, f, a.drop);
              }
#pragma unroll
              for (int g = 0; g < REP; ++g) {
                if (g >= rep) break;
                // q as a warp broadcast, 4 features a load
                const float4 qv = *reinterpret_cast<const float4*>(
                    qc + g * hd + k * PER + e4);
                part[g] = fmaf(qv.x, kv[0], part[g]);
                part[g] = fmaf(qv.y, kv[1], part[g]);
                part[g] = fmaf(qv.z, kv[2], part[g]);
                part[g] = fmaf(qv.w, kv[3], part[g]);
              }
            }
          }
        };
        if (scale != 0.f) scores(std::true_type{});
        else scores(std::false_type{});
#pragma unroll
        for (int g = 0; g < REP; ++g)
          if (g < rep) red[(c * rep + g) * kSub + lane] = part[g];
      }
      __syncthreads();
      for (int t = tid; t < rep * kSub; t += nthr) {
        const int g = t / kSub, l = t - g * kSub;
        if (l >= n) continue;
        float x = 0.f;
        for (int cc = 0; cc < nch; ++cc) x += red[(cc * rep + g) * kSub + l];
        x *= a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        st[g * SL + l0 + l] =
            slot_valid(gs0 + l0 + l, pos, a.Lg, a.window) ? x : SFP_NEG_INF;
      }
      continue;
    }

    if (i == nv) {
      // Softmax over the split's visible sub-tiles: one warp a head.
      for (int g = c; g < rep; g += nch) {
        float mx = SFP_NEG_INF;
        for (int k = 0; k < nv; ++k) {
          const int l = nth_set(vis, k) * kSub + lane;
          if (l < SLs) mx = fmaxf(mx, st[g * SL + l]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int k = 0; k < nv; ++k) {
          const int l = nth_set(vis, k) * kSub + lane;
          if (l < SLs) {
            const float p = expf(st[g * SL + l] - mx);
            st[g * SL + l] = p;
            sum += p;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) { ms[g] = mx; ls[g] = sum; }
      }
      __syncthreads();
    }

    // acc += p . v: thread d owns feature d, walks the sub-tile's slots.
    if (tid < hd) {
      const int d = tid;
      const int gi = (h * hd + d) >> 7;
      const W* col = reinterpret_cast<const W*>(wt) + d + woff;
      const int ws = wstride / (int)sizeof(W);
      const bool vec = (SL & 3) == 0;  // p rows 16-byte aligned
      for (int l = 0; l < n; l += 4) {
        float p[REP][4];
#pragma unroll
        for (int g = 0; g < REP; ++g) {
          if (g >= rep) break;
          const float* pg = st + g * SL + l0 + l;
          if (vec) {
            const float4 t = *reinterpret_cast<const float4*>(pg);
            p[g][0] = t.x; p[g][1] = t.y; p[g][2] = t.z; p[g][3] = t.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) p[g][k] = l + k < n ? pg[k] : 0.f;
          }
        }
        // The decode is chosen once for the 4 slots (uniform in the warp).
        float sc[4];
        int bi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bi[k] = (l0 + l + min(k, n - 1 - l)) * G + gi;
          sc[k] = vsc[bi[k]];
        }
        auto pv = [&](auto fast) {
          constexpr bool FAST = decltype(fast)::value;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (l + k >= n) break;
            const float vv = decode_word<FAST>(
                (uint32_t)col[(l + k) * ws], sc[k],
                FAST ? 0 : vbase[bi[k]], fd, f, a.drop);
#pragma unroll
            for (int g = 0; g < REP; ++g)
              if (g < rep) acc[g] = fmaf(p[g][k], vv, acc[g]);
          }
        };
        if (sc[0] != 0.f && sc[1] != 0.f && sc[2] != 0.f && sc[3] != 0.f)
          pv(std::true_type{});
        else
          pv(std::false_type{});
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int g = 0; g < REP; ++g)
    if (g < rep && tid < hd) part_acc[(pidx * rep + g) * hd + tid] = acc[g];
  if (tid < rep) {
    part_m[pidx * rep + tid] = ms[tid];
    part_l[pidx * rep + tid] = ls[tid];
  }
  ticket_merge(a, b, h, mbuf, last);
}

template <typename W, bool DENSE, int REP>
__global__ void decode_split_kernel(const DecodeArgs a) {
  decode_split<W, DENSE, REP>(a);
}

// REP 16 holds 16 heads' partial scores, p and acc a thread, which spill
// heavily under the file's 72-register cap (-maxrregcount, set for three
// 288-thread CTAs an SM). Its kernel declares one CTA of up to kMaxHd
// threads an SM instead, which allows 65536 / 512 = 128 registers.
template <typename W, bool DENSE>
__global__ void __launch_bounds__(kMaxHd, 1)
    decode_split_kernel_wide(const DecodeArgs a) {
  decode_split<W, DENSE, 16>(a);
}

template <typename W, bool DENSE, int REP>
void (*decode_kernel())(DecodeArgs) {
  if constexpr (REP > 8) return decode_split_kernel_wide<W, DENSE>;
  else return decode_split_kernel<W, DENSE, REP>;
}

// The largest dynamic shared memory a block may take, granted to the
// kernel once per device (not on every launch).
template <typename W, bool DENSE, int REP>
int smem_limit() {
  static int limit[kMaxDevices];  // 0: not yet granted
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (limit[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_kernel<W, DENSE, REP>(),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return -(int)err;
    limit[dev] = optin;
  }
  return limit[dev];
}

template <typename W, bool DENSE, int REP>
int launch_rep(const DecodeArgs& a, cudaStream_t stream) {
  const Layout lay = make_layout(a, DENSE, (int)sizeof(W));
  const int limit = smem_limit<W, DENSE, REP>();
  if (limit < 0) return -limit;
  if (lay.total > limit) return (int)cudaErrorInvalidValue;
  DecodeArgs args = a;
  void* params[] = {&args};
  return (int)cudaLaunchKernel(decode_kernel<W, DENSE, REP>(),
                               dim3(a.nsplit, a.KH, a.B),
                               dim3(32 * ((a.hd + 31) / 32)), params,
                               lay.total, stream);
}

// Query heads a KV head, rounded up to a power of two: the register
// arrays' length (the loops still stop at rep). REP 16 takes rep 9-16
// (mistral-large's 12, recurrentgemma's 16).
template <typename W, bool DENSE>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const int rep = a.H / a.KH;
  if (rep <= 1) return launch_rep<W, DENSE, 1>(a, stream);
  if (rep <= 2) return launch_rep<W, DENSE, 2>(a, stream);
  if (rep <= 4) return launch_rep<W, DENSE, 4>(a, stream);
  if (rep <= 8) return launch_rep<W, DENSE, 8>(a, stream);
  return launch_rep<W, DENSE, 16>(a, stream);
}

}  // namespace

// Contiguous cache: tables == nullptr, L slots per row, payload (B, L,
// cols). Paged pool: tables (B, nb) int32, L = nb * block_l logical slots,
// payload (P_blocks, block_l, cols), window -1. A split is split_l slots
// (a divisor of block_l); a contiguous cache's last split may be partial
// (ceil(L / split_l) splits). slot0 and L_global place the cache's slots
// in a longer one (0 and L for a whole cache); lse != nullptr is the shard
// view: out is then f32 (B, H, hd) and lse f32 (B, H). prefix_planes -1
// (or the payload width) reads full width. scratch: f32 of B * KH *
// ceil(L / split_l) * (H / KH) * (hd + 2) elements; tickets: B * KH int32
// zeros, left zero by the launch.
extern "C" int packed_flash_decode_launch(
    const void* q, const void* kp, const void* kb, const void* vp,
    const void* vb, const void* pos, const void* tables, void* scratch,
    void* tickets, void* out, void* lse, int B, int L, int H, int KH,
    int hd, int G, int block_l, int split_l, int window, int man_keep,
    int dexp_bits, int payload_bits, int dense, int prefix_planes,
    int slot0, int L_global, float softcap, float scale, void* stream) {
  if (B == 0 || KH == 0) return 0;
  if (H % KH != 0 || H / KH > kMaxRep || hd > kMaxHd || hd % 16 != 0
      || KH * hd != G * SFP_GROUP || block_l <= 0 || L <= 0
      || split_l <= 0 || split_l > kSub * kMaxSub || block_l % split_l != 0
      || slot0 < 0 || slot0 + L > L_global
      || (tables != nullptr && (window > 0 || L % block_l != 0
                                || slot0 != 0 || L_global != L)))
    return (int)cudaErrorInvalidValue;
  const int P = payload_bits;
  const int Pr = prefix_planes < 0 ? P : prefix_planes;
  if (Pr < dexp_bits + 2 || Pr > P || man_keep - (P - Pr) < 0)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kp = static_cast<const uint8_t*>(kp);
  a.kb = static_cast<const uint8_t*>(kb);
  a.vp = static_cast<const uint8_t*>(vp);
  a.vb = static_cast<const uint8_t*>(vb);
  a.pos = static_cast<const int*>(pos);
  a.tables = static_cast<const int*>(tables);
  a.part = static_cast<float*>(scratch);
  a.tickets = static_cast<int*>(tickets);
  a.out = lse == nullptr ? static_cast<__nv_bfloat16*>(out) : nullptr;
  a.out_f32 = lse == nullptr ? nullptr : static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.L = L; a.H = H; a.KH = KH; a.hd = hd; a.G = G;
  a.BL = block_l; a.window = window;
  a.slot0 = slot0; a.Lg = L_global;
  a.SL = split_l; a.nsplit = (L + split_l - 1) / split_l;
  // The geometry the kernel decodes: the leading Pr bits of each word.
  a.f = SfpFields{man_keep - (P - Pr), dexp_bits, Pr};
  a.P_store = P; a.Pr = Pr;
  a.softcap = softcap; a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  if (dense) {
    if (P < 3 || P > kMaxPlanes || 1 + dexp_bits + man_keep != P)
      return (int)cudaErrorInvalidValue;
    a.row_bytes = G * P * 16;
    a.drop = 0;
    return Pr <= 8 ? launch<uint8_t, true>(a, s)
                   : launch<uint16_t, true>(a, s);
  }
  a.row_bytes = G * SFP_GROUP * (P / 8);
  a.drop = P - Pr;
  if (P == 8) return launch<uint8_t, false>(a, s);
  if (P == 16) return launch<uint16_t, false>(a, s);
  return (int)cudaErrorInvalidValue;
}
