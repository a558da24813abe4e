// Online-softmax (flash) attention forward for Hopper, on tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel). Inputs q (B, Sq, H, D), k/v
// (B, Sk, H, D) bf16 with the same head count: GQA callers fold the query
// head group into the rows (q_rep), so folded row r sits at causal position
// r / q_rep. Masks: causal, a sliding window (k > q - window) and keys past
// Sk, then the first prefix_len keys made visible to every row (a
// prefix-LM's conditioning, the mask of the JAX package's ref.attention,
// which its Pallas kernel never receives); masked logits are -1e30 (not
// -inf), as in the JAX kernel. Logit
// softcap c: s = c * tanh(s / c). Scores, softmax and the output
// accumulator are f32; the output is bf16. An optional f32 output holds
// each row's log-sum-exp (m + log l, shape (B*H, Sq)), which the backward
// kernels (flash_attention_bwd.cu) use to rebuild the probabilities; a
// null pointer skips it (serving).
//
// Bound on this card: operations (2 * 2 * rows * keys * D per head, halved
// by the causal mask), which only the tensor cores reach in bf16. Design:
// one CTA of two warpgroups (256 threads) per (batch*head, 128-row query
// tile); each warpgroup owns 64 rows. Key tiles of 32 (K and V) are staged
// by 16-byte cp.async two deep in the 64-byte swizzled layout of
// attention_tc.cuh, so tile t + 1 loads while tile t computes. Per tile:
//   S = Q K^T   wgmma m64n32k16, Q and K K-major in shared memory, D/16
//               steps spread over three accumulators, added in f32
//   softmax     in the accumulator registers; row max and sum over the four
//               threads of a row (shuffles); P split into three bf16 terms
//   O += P V    per 32-column panel of D: wgmma m64n32k16 of each term (P
//               from registers as A, V MN-major) into a fresh accumulator,
//               then O = alpha O + PV by f32 FMAs while the next panel's
//               products run (two accumulators in flight)
// Precision is what the training gates ask for: the wgmma accumulators
// truncate at each step, and the QM stash estimator of a low-bits qm +
// sfp8 step (a sum of 9.4 M terms that cancels to 1/550 of their
// magnitudes) amplifies every one-ulp flip of the attention output. A
// first design, P as bf16 hi + lo (2^-17) accumulated straight into O over
// all tiles, moved that estimator 0.0028 from the plain path's against a
// limit of 0.0018 (chip_smoke.py on the H100); one bf16 term (2^-9) puts
// outputs outside the one-ulp gate itself (plain_tiled on the CPU). Three
// terms (24 bits), a fresh accumulator per tile and panel, and S over
// three partial sums keep each truncation small against what it
// truncates (chip_smoke.py counts the outputs that round away from the
// plain version's and from the f64 function's); the three P V products
// cost the forward 2x the operations of one. The row sum l adds the same
// three-term P that multiplies V, so O stays a convex combination of V's
// rows. Key tiles that every row masks (above the causal diagonal, before
// the window) are skipped, an exact no-op of the recurrence; tiles every
// pair of which is visible skip the mask arithmetic. Query tiles are
// launched longest first (the last rows of a causal sequence see every
// key). kernels/flash_attention.py:tile_plan lists the same tiles, and
// plain_tiled runs the same recurrence on the CPU.
// Head dims 144 and 240 (= 16 mod 32) run in tiles of D = 160 and 256
// columns whose last 16 are zero-filled in shared memory (attention_tc.cuh:
// no bytes read, none written): S takes DH / 16 k-steps, P V runs the
// whole last panel and drops its zero half, 1/10 (144) and 1/16 (240) more
// tensor-core work than the head needs in P V alone.
// Shared memory at D = 288: Q 128 x 288 (73,728 B) + 2 stages of K and V
// 32 x 288 (73,728 B) = 147,456 B (+1 KB to align the swizzle atoms).
// Registers a thread: O 9 x 16 f32; then S 3 x 16 f32, or P 3 x 8 x 32-bit
// and two panels' products 2 x 16 f32 (wider panels spilled at hd 256 and
// 288).
#include "attention_tc.cuh"

namespace {

using attn::bf16;

constexpr int BQ = 128;  // query rows a CTA (two warpgroups of 64)
constexpr int BK = 32;   // keys a tile
constexpr int kThreads = 256;
constexpr int kTerms = 3;  // bf16 terms of P in P V

template <int D>
struct Smem {
  static constexpr int kQ = attn::Tile<BQ, D>::kBytes;
  static constexpr int kKV = attn::Tile<BK, D>::kBytes;
  static constexpr int kBytes = kQ + 4 * kKV + 1024;
};

// Issue (and commit) the products of a tile's P, in kTerms bf16 terms
// (smallest first), with panel c of V (32 columns) into a fresh
// accumulator.
__device__ __forceinline__ void panel_pv(
    float (&acc)[16], const uint32_t (&pa)[kTerms][BK / 16][4], uint32_t sV,
    int c) {
  attn::wgmma_fence();
#pragma unroll
  for (int term = kTerms - 1; term >= 0; --term)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      attn::wgmma_rs(acc, pa[term][kk], attn::mnmajor<BK>(sV, c, kk),
                     term < kTerms - 1 || kk > 0);
  attn::wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int q_rep, int causal, int window, int prefix_len,
                       float softcap, float scale) {
  constexpr int D = attn::pad32(DH);  // the tile's columns
  constexpr int kPanels = D / 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (attn::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK0 = sQ + Smem<D>::kQ;
  const uint32_t sV0 = sK0 + 2 * Smem<D>::kKV;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int rs = H * DH;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * DH;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * DH;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * DH;

  // Key tiles any row of this CTA can see. With a prefix and a window,
  // the tiles between them are visited and masked whole: an exact no-op,
  // since the prefix's first tile has set every row's running max.
  const int r_last = min(r0 + BQ, Sq) - 1;
  int k_begin, k_end;
  attn::key_range(r0 / q_rep, r_last / q_rep, Sk, causal, window,
                  prefix_len, k_begin, k_end);
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  attn::load_tile<BQ, D, kThreads, DH>(sQ, qb, rs, r0, Sq, tid);
  if (t_begin < t_end) {
    attn::load_tile<BK, D, kThreads, DH>(sK0, kb, rs, t_begin * BK, Sk, tid);
    attn::load_tile<BK, D, kThreads, DH>(sV0, vb, rs, t_begin * BK, Sk, tid);
  }
  attn::cp_async_commit();

  // This thread's two rows (accumulator rows l/4 and l/4 + 8 of its warp).
  const int row_a = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int qpos[2] = {row_a / q_rep, (row_a + 8) / q_rep};
  const int col0 = 2 * (lane & 3);
  const uint32_t q_rows = wg * 64 * 64;  // this warpgroup's rows in a panel

  float o[kPanels][16];  // 32 columns of D each
#pragma unroll
  for (int c = 0; c < kPanels; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[c][i] = 0.f;
  float m[2] = {SFP_NEG_INF, SFP_NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    const uint32_t sK = sK0 + st * Smem<D>::kKV, sV = sV0 + st * Smem<D>::kKV;
    attn::cp_async_land();  // tile t is in; every thread is done with t - 1
    if (t + 1 < t_end) {
      const uint32_t nK = sK0 + (st ^ 1) * Smem<D>::kKV;
      const uint32_t nV = sV0 + (st ^ 1) * Smem<D>::kKV;
      attn::load_tile<BK, D, kThreads, DH>(nK, kb, rs, (t + 1) * BK, Sk, tid);
      attn::load_tile<BK, D, kThreads, DH>(nV, vb, rs, (t + 1) * BK, Sk, tid);
    }
    attn::cp_async_commit();

    // S over DH / 16 k-steps, step kk into partial sum kk % 3, added in
    // f32.
    float s[BK / 2] = {}, s1[BK / 2] = {}, s2[BK / 2] = {};
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t da = attn::kmajor<BQ>(sQ, q_rows, kk);
      const uint64_t db = attn::kmajor<BK>(sK, 0, kk);
      if (kk % 3 == 0) attn::wgmma_ss(s, da, db, kk >= 3);
      if (kk % 3 == 1) attn::wgmma_ss(s1, da, db, kk >= 3);
      if (kk % 3 == 2) attn::wgmma_ss(s2, da, db, kk >= 3);
    }
    attn::wgmma_commit();
    attn::wgmma_wait();
    attn::fence_regs(s);
    attn::fence_regs(s1);
    attn::fence_regs(s2);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = (s[i] + s1[i]) + s2[i];

    const int k0 = t * BK;
    const bool open = attn::tile_open(r0, r_last, k0, k0 + BK - 1, Sk, q_rep,
                                      causal, window, prefix_len);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int rr = (i >> 1) & 1;
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (!open) {
        const int kp = k0 + (i >> 2) * 8 + col0 + (i & 1);
        if (!attn::visible(qpos[rr], kp, Sk, causal, window, prefix_len))
          x = SFP_NEG_INF;
      }
      s[i] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      alpha[rr] = expf(m[rr] - mx[rr]);
      m[rr] = mx[rr];
      l[rr] *= alpha[rr];  // this thread's share of the row sum
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = expf(s[i] - m[(i >> 1) & 1]);
    // P as three bf16 terms in the A-fragment order; the row sum adds what
    // they hold.
    uint32_t pa[kTerms][BK / 16][4];
    attn::to_a_terms(s, pa, l);

    // O = alpha O + P V, one 32-column panel of D at a time: the tile's
    // product sums in a fresh accumulator, then joins O by f32 FMAs while
    // the next panel's products run.
    float pv[2][16] = {};
    panel_pv(pv[0], pa, sV, 0);
#pragma unroll
    for (int c = 0; c < kPanels; ++c) {
      if (c + 1 < kPanels) {
        panel_pv(pv[(c + 1) & 1], pa, sV, c + 1);
        attn::wgmma_wait<1>();
      } else {
        attn::wgmma_wait<0>();
      }
      attn::fence_regs(pv[c & 1]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        o[c][i] = fmaf(o[c][i], alpha[(i >> 1) & 1], pv[c & 1][i]);
    }
    attn::fence_regs(pa);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int r = row_a + 8 * rr;
    if (r >= Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f), inv = 1.f / den;
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * Sq + r] = m[rr] + logf(den);
    bf16* orow = out + (((size_t)b * Sq + r) * H + h) * DH + col0;
#pragma unroll
    for (int c = 0; c < kPanels; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c * 32 + 8 * j >= DH) continue;  // the zero columns
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 32 + 8 * j) =
            __floats2bfloat162_rn(o[c][i] * inv, o[c][i + 1] * inv);
      }
  }
}

template <int DH>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
           float* lse, int B, int Sq, int Sk, int H, int q_rep, int causal,
           int window, int prefix_len, int q_tiles, float softcap,
           float scale, cudaStream_t stream) {
  constexpr int D = attn::pad32(DH);
  static int granted[attn::kMaxDevices];
  if (q_tiles != (Sq + BQ - 1) / BQ) return (int)cudaErrorInvalidValue;
  const int err = attn::grant_smem(flash_attention_kernel<DH>,
                                   Smem<D>::kBytes, granted);
  if (err != 0) return err;
  flash_attention_kernel<DH><<<dim3(B * H, q_tiles), kThreads,
                               Smem<D>::kBytes, stream>>>(
      q, k, v, out, lse, Sq, Sk, H, q_rep, causal, window, prefix_len,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int D,
                                      int q_rep, int causal, int window,
                                      int prefix_len, int q_tiles,
                                      float softcap, float scale,
                                      void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  if (!attn::aligned16(q) || !attn::aligned16(k) || !attn::aligned16(v)
      || !attn::aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
#define FA_FWD(DIM)                                                        \
  launch<DIM>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),    \
              static_cast<const bf16*>(v), static_cast<bf16*>(out), l, B,  \
              Sq, Sk, H, q_rep, causal, window, prefix_len, q_tiles,     \
              softcap, scale, s)
  switch (D) {
    case 64: return FA_FWD(64);
    case 128: return FA_FWD(128);
    case 144: return FA_FWD(144);
    case 192: return FA_FWD(192);
    case 240: return FA_FWD(240);
    case 256: return FA_FWD(256);
    case 288: return FA_FWD(288);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_FWD
}
