// Flash attention backward for Hopper, on tensor cores: dQ, dK, dV of
// flash_attention.cu.
//
// The TPU package has no backward kernel for src/repro/kernels/
// flash_attention.py:flash_attention, and JAX cannot differentiate that
// Pallas call; it trains through the dense oracle ref.attention. This is
// the gradient of that same function (causal / sliding-window masks with
// the folded-row position r / q_rep, the first prefix_len keys visible to
// every row, -1e30 masking, logit softcap
// c * tanh(x / c)), computed FA2-style from q, k, v, the forward output o,
// dO and the forward's per-row log-sum-exp, in three launches:
//   1. delta_r = sum_d dO[r, d] * O[r, d]       (one warp per row, bf16 O)
//   2. per (batch*head, 64-key tile): loop over the 32-row query tiles that
//      can see the keys; dK and dV accumulate in registers;
//   3. per (batch*head, 128-row query tile): loop over the 32-key tiles it
//      can see; dQ accumulates in registers.
// No floating-point atomics: each output element is summed by one thread
// in a fixed order, so two launches are bit-equal and a batch row's
// gradients do not depend on the other rows.
//
// Bound on this card: operations (5 products of 2 * D flops per visible
// (row, key) pair; the dQ pass recomputes two of them). Every product runs
// on the tensor cores (wgmma, bf16 in, f32 accumulators), from tiles
// staged by 16-byte cp.async two deep in the 64-byte swizzled layout of
// attention_tc.cuh:
//   dK/dV (256 threads, two warpgroups with different products). A 64-key
//     tile's dK and dV at D = 288 are 2 x 144 f32 a thread in one
//     warpgroup, more than the 255 registers allowed, so warpgroup 0 owns
//     dV and warpgroup 1 dK (144 f32 each):
//       wg 0: S^T = K Q^T (m64n32, K and Q K-major), P^T = exp(s - lse),
//             g = P (1 - t^2) (t the softcap's tanh) to shared memory in
//             its fragment order (f32, 8 KB), dV += P^T dO (P^T from
//             registers as bf16, dO MN-major);
//       wg 1: dP^T = V dO^T (m64n32), waits for g (named barrier),
//             dS^T = g (dP^T - delta) rounded to bf16, dK += dS^T Q.
//     Both accumulator tiles (64 keys x 32 rows) have the same fragment
//     layout, so thread t of warpgroup 1 reads exactly what thread t of
//     warpgroup 0 wrote. Registers a thread: 144 + 16 + 8 and the row data.
//     Shared memory at D = 288: K and V 64 x 288 (73,728 B) + 2 stages of
//     Q and dO 32 x 288 and the rows' lse and delta (75,776 B) + g (8,192
//     B) = 157,696 B.
//   dQ (256 threads, each warpgroup 64 rows, as the forward): S = Q K^T and
//     dP = dO V^T (m64n32), dS = P (dP - delta) (1 - t^2) rounded to bf16,
//     dQ += dS K (dS from registers, K MN-major). Registers: dQ 144 f32,
//     S and dP 16 each, dS 8. Shared memory at D = 288: Q and dO 128 x 288
//     (147,456 B) + 2 stages of K and V 32 x 288 (73,728 B) = 221,184 B.
// Head dims 144 and 240 (= 16 mod 32) run in tiles of D = 160 and 256
// columns, the last 16 zero-filled in shared memory (attention_tc.cuh):
// S and dP take DH / 16 k-steps; dV, dK and dQ run whole chunks and store
// only their first DH columns (the rest are products with zeros).
// P and dS enter their products (dV, dK, dQ) as bf16, a 2^-9 relative
// rounding of each term that the gradients' 2^-6 gate absorbs (the
// forward's output, which the stash estimators amplify, takes P as three
// bf16 terms; flash_attention.cu). Scores are recomputed on the tensor
// cores in one accumulator (the forward spreads its k-steps over three),
// so P matches the forward's probabilities to f32 rounding, not bit for
// bit. Tiles the causal or window mask empties are skipped, tiles every
// pair of which is visible skip the mask arithmetic
// (kernels/flash_attention.py:tile_plan lists them, and plain_bwd_tiled
// runs the same recurrence with the same roundings on the CPU). dQ/dK/dV
// are bf16.
#include "attention_tc.cuh"

namespace {

using attn::bf16;

constexpr int kThreads = 256;
constexpr int KV_BK = 64, KV_BQ = 32;  // dK/dV pass: keys a CTA, rows a tile
constexpr int Q_BQ = 128, Q_BK = 32;   // dQ pass: rows a CTA, keys a tile

// The N-chunks of the D output columns of dV, dK and dQ: wgmma takes N <=
// 256, and each chunk is a whole number of 32-column panels (64 -> 64,
// 128 -> 128, 160 -> 5 x 32, 192 -> 2 x 96, 256 -> 2 x 128, 288 -> 3 x 96).
template <int D>
struct Chunks {
  static constexpr int N = D == 64 ? 64
      : (D % 128 == 0 ? 128 : (D % 96 == 0 ? 96 : 32));
  static constexpr int kCount = D / N;
  static constexpr int kPanels = N / 32;
  static_assert(D % N == 0, "head dim not a whole number of chunks");
};

__global__ void bwd_delta_kernel(const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout,
                                 float* __restrict__ delta, int rows, int Sq,
                                 int H, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // row = (b * Sq + r) * H + h
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(o + (size_t)row * D);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * D);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 a = __bfloat1622float2(o2[c]);
    const float2 g = __bfloat1622float2(d2[c]);
    acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, r = (row / H) % Sq, b = row / (H * Sq);
    delta[((size_t)b * H + h) * Sq + r] = acc;
  }
}

template <int D>
struct KVSmem {
  static constexpr int kKey = attn::Tile<KV_BK, D>::kBytes;
  static constexpr int kRow = attn::Tile<KV_BQ, D>::kBytes;
  // Q, dO, then lse and delta (256 B, padded so each stage starts on a
  // swizzle-atom boundary).
  static constexpr int kStage = 2 * kRow + 1024;
  static constexpr int kG = KV_BK * KV_BQ * 4;
  static constexpr int kBytes = 2 * kKey + 2 * kStage + kG + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                int H, int q_rep, int causal, int window, int prefix_len,
                float softcap, float scale) {
  constexpr int D = attn::pad32(DH);  // the tiles' columns
  using CH = Chunks<D>;
  using SM = KVSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (attn::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + SM::kKey, sStage = sV + SM::kKey;
  const uint32_t sG = sStage + 2 * SM::kStage;
  // Generic pointers to the g exchange tile and the stages' row data.
  unsigned char* gen = smem_raw + (base - attn::smem_u32(smem_raw));
  float* g_tile = reinterpret_cast<float*>(gen + (sG - base));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * KV_BK;  // the first key tiles see the most rows
  const int rs = H * DH;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * DH;
  const bf16* ob = dout + ((size_t)b * Sq * H + h) * DH;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * DH;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * DH;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;

  // Query tiles with a row that can see a key of this tile: every row,
  // when the tile starts inside the prefix.
  const bool in_prefix = k0 < prefix_len;
  const int r_begin = causal && !in_prefix ? k0 * q_rep : 0;
  const int r_end = window > 0 && !in_prefix
                        ? min(Sq, (k0 + KV_BK - 1 + window) * q_rep)
                        : Sq;
  const int i_begin = r_begin / KV_BQ, i_end = (r_end + KV_BQ - 1) / KV_BQ;

  auto stage_of = [&](int st) { return sStage + st * SM::kStage; };
  auto load_rows = [&](int st, int r0) {
    const uint32_t s0 = stage_of(st);
    attn::load_tile<KV_BQ, D, kThreads, DH>(s0, qb, rs, r0, Sq, tid);
    attn::load_tile<KV_BQ, D, kThreads, DH>(s0 + SM::kRow, ob, rs, r0, Sq,
                                            tid);
    attn::load_vec(s0 + 2 * SM::kRow, lse_b, r0, KV_BQ, Sq, tid);
    attn::load_vec(s0 + 2 * SM::kRow + KV_BQ * 4, delta_b, r0, KV_BQ, Sq,
                   tid - KV_BQ);
  };

  attn::load_tile<KV_BK, D, kThreads, DH>(sK, kb, rs, k0, Sk, tid);
  attn::load_tile<KV_BK, D, kThreads, DH>(sV, vb, rs, k0, Sk, tid);
  if (i_begin < i_end) load_rows(0, i_begin * KV_BQ);
  attn::cp_async_commit();

  // This thread's two keys (accumulator rows) and the tile columns (query
  // rows) 8 j + col0 + {0, 1} it holds.
  const int key_a = k0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  float acc[CH::kCount][CH::N / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int c = 0; c < CH::kCount; ++c)
#pragma unroll
    for (int i = 0; i < CH::N / 2; ++i) acc[c][i] = 0.f;

  for (int it = i_begin; it < i_end; ++it) {
    const int st = (it - i_begin) & 1;
    const uint32_t sQ = stage_of(st), sdO = sQ + SM::kRow;
    const float* rowdata =
        reinterpret_cast<const float*>(gen + (sQ + 2 * SM::kRow - base));
    attn::cp_async_land();  // tile it is in; every thread is done with it - 1
    if (it + 1 < i_end) load_rows(st ^ 1, (it + 1) * KV_BQ);
    attn::cp_async_commit();

    const int r0 = it * KV_BQ;
    const bool open = attn::tile_open(r0, min(r0 + KV_BQ, Sq) - 1, k0,
                                      k0 + KV_BK - 1, Sk, q_rep, causal,
                                      window, prefix_len);
    float s[KV_BQ / 2] = {}, unused[2] = {};
    uint32_t pa[1][KV_BQ / 16][4];
    if (wg == 0) {
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        attn::wgmma_ss(s, attn::kmajor<KV_BK>(sK, 0, kk),
                       attn::kmajor<KV_BQ>(sQ, 0, kk), kk > 0);
      attn::wgmma_commit();
      attn::wgmma_wait();
      attn::fence_regs(s);
#pragma unroll
      for (int i = 0; i < KV_BQ / 2; ++i) {
        const int col = (i >> 2) * 8 + col0 + (i & 1);
        const int kp = key_a + 8 * ((i >> 1) & 1);
        float x = s[i] * scale, t = 0.f;
        if (softcap > 0.f) {
          t = tanhf(x / softcap);
          x = softcap * t;
        }
        float p = expf(x - rowdata[col]);
        if (!open) {
          const int r = r0 + col;
          if (r >= Sq || !attn::visible(r / q_rep, kp, Sk, causal, window,
                                        prefix_len))
            p = 0.f;
        }
        g_tile[i * 128 + wtid] = softcap > 0.f ? p * (1.f - t * t) : p;
        s[i] = p;
      }
      __threadfence_block();
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // g is written
      attn::to_a_terms(s, pa, unused);
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < CH::kCount; ++c)
          attn::wgmma_rs(acc[c], pa[0][kk],
                         attn::mnmajor<KV_BQ>(sdO, c * CH::kPanels, kk), 1);
    } else {
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        attn::wgmma_ss(s, attn::kmajor<KV_BK>(sV, 0, kk),
                       attn::kmajor<KV_BQ>(sdO, 0, kk), kk > 0);
      attn::wgmma_commit();
      attn::wgmma_wait();
      attn::fence_regs(s);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // wait for g
#pragma unroll
      for (int i = 0; i < KV_BQ / 2; ++i) {
        const int col = (i >> 2) * 8 + col0 + (i & 1);
        s[i] = g_tile[i * 128 + wtid] * (s[i] - rowdata[KV_BQ + col]);
      }
      attn::to_a_terms(s, pa, unused);
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < CH::kCount; ++c)
          attn::wgmma_rs(acc[c], pa[0][kk],
                         attn::mnmajor<KV_BQ>(sQ, c * CH::kPanels, kk), 1);
    }
    attn::wgmma_commit();
    attn::wgmma_wait();
#pragma unroll
    for (int c = 0; c < CH::kCount; ++c) attn::fence_regs(acc[c]);
    attn::fence_regs(pa);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  bf16* dst = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kk = key_a + 8 * rr;
    if (kk >= Sk) continue;
    bf16* row = dst + (((size_t)b * Sk + kk) * H + h) * DH + col0;
#pragma unroll
    for (int c = 0; c < CH::kCount; ++c)
#pragma unroll
      for (int j = 0; j < CH::N / 8; ++j) {
        if (c * CH::N + 8 * j >= DH) continue;  // the zero columns
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(row + c * CH::N + 8 * j) =
            __floats2bfloat162_rn(acc[c][i] * mul, acc[c][i + 1] * mul);
      }
  }
}

template <int D>
struct QSmem {
  static constexpr int kRow = attn::Tile<Q_BQ, D>::kBytes;
  static constexpr int kKey = attn::Tile<Q_BK, D>::kBytes;
  static constexpr int kBytes = 2 * kRow + 4 * kKey + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Sq, int Sk, int H, int q_rep,
              int causal, int window, int prefix_len, float softcap,
              float scale) {
  constexpr int D = attn::pad32(DH);  // the tiles' columns
  using CH = Chunks<D>;
  using SM = QSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (attn::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + SM::kRow, sK0 = sdO + SM::kRow;
  const uint32_t sV0 = sK0 + 2 * SM::kKey;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * Q_BQ;  // longest tiles first
  const int rs = H * DH;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * DH;
  const bf16* ob = dout + ((size_t)b * Sq * H + h) * DH;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * DH;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * DH;

  // Key tiles any row of this CTA can see (as in the forward).
  const int r_last = min(r0 + Q_BQ, Sq) - 1;
  int k_begin, k_end;
  attn::key_range(r0 / q_rep, r_last / q_rep, Sk, causal, window,
                  prefix_len, k_begin, k_end);
  const int t_begin = k_begin / Q_BK, t_end = (k_end + Q_BK - 1) / Q_BK;

  attn::load_tile<Q_BQ, D, kThreads, DH>(sQ, qb, rs, r0, Sq, tid);
  attn::load_tile<Q_BQ, D, kThreads, DH>(sdO, ob, rs, r0, Sq, tid);
  if (t_begin < t_end) {
    attn::load_tile<Q_BK, D, kThreads, DH>(sK0, kb, rs, t_begin * Q_BK, Sk,
                                           tid);
    attn::load_tile<Q_BK, D, kThreads, DH>(sV0, vb, rs, t_begin * Q_BK, Sk,
                                           tid);
  }
  attn::cp_async_commit();

  const int row_a = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t q_rows = wg * 64 * 64;
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row_a + 8 * rr;
    qpos[rr] = r / q_rep;
    lse_r[rr] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    delta_r[rr] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }

  float acc[CH::kCount][CH::N / 2];
#pragma unroll
  for (int c = 0; c < CH::kCount; ++c)
#pragma unroll
    for (int i = 0; i < CH::N / 2; ++i) acc[c][i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    const uint32_t sK = sK0 + st * SM::kKey, sV = sV0 + st * SM::kKey;
    attn::cp_async_land();
    if (t + 1 < t_end) {
      const uint32_t nK = sK0 + (st ^ 1) * SM::kKey;
      const uint32_t nV = sV0 + (st ^ 1) * SM::kKey;
      attn::load_tile<Q_BK, D, kThreads, DH>(nK, kb, rs, (t + 1) * Q_BK, Sk,
                                             tid);
      attn::load_tile<Q_BK, D, kThreads, DH>(nV, vb, rs, (t + 1) * Q_BK, Sk,
                                             tid);
    }
    attn::cp_async_commit();

    float s[Q_BK / 2] = {}, dp[Q_BK / 2] = {};
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      attn::wgmma_ss(s, attn::kmajor<Q_BQ>(sQ, q_rows, kk),
                     attn::kmajor<Q_BK>(sK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      attn::wgmma_ss(dp, attn::kmajor<Q_BQ>(sdO, q_rows, kk),
                     attn::kmajor<Q_BK>(sV, 0, kk), kk > 0);
    attn::wgmma_commit();
    attn::wgmma_wait();
    attn::fence_regs(s);
    attn::fence_regs(dp);

    const int k0 = t * Q_BK;
    const bool open = attn::tile_open(r0, r_last, k0, k0 + Q_BK - 1, Sk,
                                      q_rep, causal, window, prefix_len);
#pragma unroll
    for (int i = 0; i < Q_BK / 2; ++i) {
      const int rr = (i >> 1) & 1;
      float x = s[i] * scale, t2 = 0.f;
      if (softcap > 0.f) {
        const float th = tanhf(x / softcap);
        x = softcap * th;
        t2 = th * th;
      }
      float p = expf(x - lse_r[rr]);
      if (!open) {
        const int kp = k0 + (i >> 2) * 8 + col0 + (i & 1);
        if (!attn::visible(qpos[rr], kp, Sk, causal, window, prefix_len))
          p = 0.f;
      }
      float d = p * (dp[i] - delta_r[rr]);
      if (softcap > 0.f) d *= 1.f - t2;
      s[i] = d;
    }
    uint32_t pa[1][Q_BK / 16][4];
    float unused[2] = {};
    attn::to_a_terms(s, pa, unused);
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q_BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < CH::kCount; ++c)
        attn::wgmma_rs(acc[c], pa[0][kk],
                       attn::mnmajor<Q_BK>(sK, c * CH::kPanels, kk), 1);
    attn::wgmma_commit();
    attn::wgmma_wait();
#pragma unroll
    for (int c = 0; c < CH::kCount; ++c) attn::fence_regs(acc[c]);
    attn::fence_regs(pa);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row_a + 8 * rr;
    if (r >= Sq) continue;
    bf16* row = dq + (((size_t)b * Sq + r) * H + h) * DH + col0;
#pragma unroll
    for (int c = 0; c < CH::kCount; ++c)
#pragma unroll
      for (int j = 0; j < CH::N / 8; ++j) {
        if (c * CH::N + 8 * j >= DH) continue;  // the zero columns
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(row + c * CH::N + 8 * j) =
            __floats2bfloat162_rn(acc[c][i] * scale, acc[c][i + 1] * scale);
      }
  }
}

template <int DH>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Sk, int H, int q_rep,
           int causal, int window, int prefix_len, int kv_tiles,
           int q_tiles, float softcap, float scale, cudaStream_t stream) {
  constexpr int D = attn::pad32(DH);
  static int granted_kv[attn::kMaxDevices], granted_q[attn::kMaxDevices];
  if (kv_tiles != (Sk + KV_BK - 1) / KV_BK
      || q_tiles != (Sq + Q_BQ - 1) / Q_BQ)
    return (int)cudaErrorInvalidValue;
  int err = attn::grant_smem(bwd_dkdv_kernel<DH>, KVSmem<D>::kBytes,
                             granted_kv);
  if (err == 0)
    err = attn::grant_smem(bwd_dq_kernel<DH>, QSmem<D>::kBytes, granted_q);
  if (err != 0) return err;

  const int rows = B * Sq * H;
  const int warps = kThreads / 32;
  bwd_delta_kernel<<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(
      o, dout, delta, rows, Sq, H, DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<DH><<<dim3(B * H, kv_tiles), kThreads, KVSmem<D>::kBytes,
                        stream>>>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk,
                                 H, q_rep, causal, window, prefix_len,
                                 softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<DH><<<dim3(B * H, q_tiles), kThreads, QSmem<D>::kBytes,
                      stream>>>(q, k, v, dout, lse, delta, dq, Sq, Sk, H,
                               q_rep, causal, window, prefix_len, softcap,
                               scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int D, int q_rep, int causal,
    int window, int prefix_len, int kv_tiles, int q_tiles, float softcap,
    float scale, void* stream) {
  if (B * H == 0 || Sq == 0 || Sk == 0) return 0;
  if (!attn::aligned16(q) || !attn::aligned16(k) || !attn::aligned16(v)
      || !attn::aligned16(dout) || !attn::aligned16(dq)
      || !attn::aligned16(dk) || !attn::aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
#define FA_BWD(DIM)                                                          \
  launch<DIM>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),      \
              static_cast<const bf16*>(v), static_cast<const bf16*>(o),      \
              static_cast<const bf16*>(dout), static_cast<const float*>(lse),\
              static_cast<float*>(delta), static_cast<bf16*>(dq),            \
              static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Sk, H,  \
              q_rep, causal, window, prefix_len, kv_tiles, q_tiles,        \
              softcap, scale, s)
  switch (D) {
    case 64: return FA_BWD(64);
    case 128: return FA_BWD(128);
    case 144: return FA_BWD(144);
    case 192: return FA_BWD(192);
    case 240: return FA_BWD(240);
    case 256: return FA_BWD(256);
    case 288: return FA_BWD(288);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD
}
