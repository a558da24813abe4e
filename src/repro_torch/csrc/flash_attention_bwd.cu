// Flash attention backward for Hopper: dQ, dK, dV of flash_attention.cu.
//
// The TPU package has no backward kernel for src/repro/kernels/
// flash_attention.py:flash_attention, and JAX cannot differentiate that
// Pallas call; it trains through the dense oracle ref.attention. This is
// the gradient of that same function (causal / sliding-window masks with
// the folded-row position r / q_rep, -1e30 masking, logit softcap
// c * tanh(x / c)), computed FA2-style from q, k, v, the forward output o,
// dO and the forward's per-row log-sum-exp:
//   1. delta_r = sum_d dO[r, d] * O[r, d]                   (one warp per row)
//   2. per (batch*head, 32-key tile): loop over the 64-row query tiles that
//      can see the keys; recompute P = exp(s - lse), dP = dO V^T,
//      dS = P * (dP - delta) * (1 - (s/c)^2); accumulate dV += P^T dO and
//      dK += dS^T Q in registers. The GQA group is folded into the rows, so
//      the loop over rows sums the rep group members of a KV head.
//   3. per (batch*head, 64-row query tile): loop over the key tiles it can
//      see, recompute dS the same way and accumulate dQ += dS K.
// Scores are recomputed with the forward's exact FMA order, so P matches
// the forward's probabilities. Accumulators are f32; dQ/dK/dV are bf16.
//
// Bound on this card: operations (5 products of 2 * D flops per visible
// (row, key) pair; the dQ pass recomputes two of them). Design, simple
// first: scalar f32 FMAs from bf16 tiles in shared memory (~125 KB at
// D = 288, so D is a template parameter through D / 16 as in the forward),
// tiles that the causal or window mask empties are skipped. wgmma/TMA are
// later work.
#include "sfp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 32;  // keys per tile
constexpr int PS = BKV + 1;  // padded f32 row stride of the P / dS tiles

using bf16 = __nv_bfloat16;

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

// Rows [row0, row0 + nrows) of head h of a (B, S, H, D) bf16 tensor into
// shared memory with row stride D + 2; rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int row0, int nrows, int S, int H,
                                          int h) {
  for (int idx = threadIdx.x; idx < nrows * (D / 2); idx += kThreads) {
    const int r = idx / (D / 2), c = idx % (D / 2);
    uint32_t val = 0u;
    if (row0 + r < S)
      val = reinterpret_cast<const uint32_t*>(
          src + (((size_t)b * S + row0 + r) * H + h) * D)[c];
    reinterpret_cast<uint32_t*>(dst + r * (D + 2))[c] = val;
  }
}

// Per thread: rows ty*4+i (i < 4) x keys tx+16j (j < 2) of the tile, the
// raw score q.k and dP = dO.v, in the forward kernel's FMA order.
template <int D>
__device__ __forceinline__ void tile_scores(const bf16* Qs, const bf16* dOs,
                                            const bf16* Ks, const bf16* Vs,
                                            int ty, int tx, float s[4][2],
                                            float dp[4][2]) {
  constexpr int DS = D + 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
  for (int d2 = 0; d2 < D / 2; ++d2) {
    float2 qf[4], of[4], kf[2], vf[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qf[i] = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(Qs + (ty * 4 + i) * DS)[d2]);
      of[i] = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(dOs + (ty * 4 + i) * DS)[d2]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kf[j] = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(Ks + (tx + 16 * j) * DS)[d2]);
      vf[j] = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(Vs + (tx + 16 * j) * DS)[d2]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qf[i].x, kf[j].x, fmaf(qf[i].y, kf[j].y, s[i][j]));
        dp[i][j] = fmaf(of[i].x, vf[j].x, fmaf(of[i].y, vf[j].y, dp[i][j]));
      }
  }
}

struct RowInfo {
  int qpos[4];
  bool ok[4];
  float lse[4], delta[4];
};

__device__ __forceinline__ RowInfo row_info(int r0, int ty, int bh, int Sq,
                                            int q_rep, const float* lse,
                                            const float* delta) {
  RowInfo ri;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    ri.ok[i] = r < Sq;
    ri.qpos[i] = r / q_rep;
    ri.lse[i] = ri.ok[i] ? lse[(size_t)bh * Sq + r] : 0.f;
    ri.delta[i] = ri.ok[i] ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  return ri;
}

// P = exp(s - lse) on visible (row, key) pairs (0 elsewhere) and
// dS = dL/d(scale * q.k) = P * (dP - delta) * (1 - (s/c)^2).
__device__ __forceinline__ void tile_probs(const float s[4][2],
                                           const float dp[4][2],
                                           const RowInfo& ri, int k0, int tx,
                                           int Sk, int causal, int window,
                                           float softcap, float scale,
                                           float p[4][2], float ds[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kp = k0 + tx + 16 * j;
      bool ok = ri.ok[i] && kp < Sk;
      if (causal) ok = ok && (kp <= ri.qpos[i]);
      if (window > 0) ok = ok && (kp > ri.qpos[i] - window);
      float x = s[i][j] * scale, t = 0.f;
      if (softcap > 0.f) {
        t = tanhf(x / softcap);
        x = softcap * t;
      }
      const float pv = ok ? expf(x - ri.lse[i]) : 0.f;
      float d = pv * (dp[i][j] - ri.delta[i]);
      if (softcap > 0.f) d *= 1.f - t * t;
      p[i][j] = pv;
      ds[i][j] = d;
    }
}

template <int NJ>  // NJ = D / 16
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                int H, int q_rep, int causal, int window, float softcap,
                float scale) {
  constexpr int D = NJ * 16;
  constexpr int DS = D + 2;
  constexpr int NC = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * DS;
  bf16* Qs = Vs + BKV * DS;
  bf16* dOs = Qs + BQ * DS;
  float* Ps = reinterpret_cast<float*>(dOs + BQ * DS);
  float* dSs = Ps + BQ * PS;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // score mapping
  const int warp = tid >> 5, lane = tid & 31;  // accumulate mapping
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BKV;

  load_rows<D>(Ks, k, b, k0, BKV, Sk, H, h);
  load_rows<D>(Vs, v, b, k0, BKV, Sk, H, h);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) { dk_acc[i][j] = 0.f; dv_acc[i][j] = 0.f; }

  // Folded rows that can see a key of this tile.
  const int r_begin = causal ? k0 * q_rep : 0;
  const int r_end = window > 0 ? min(Sq, (k0 + BKV - 1 + window) * q_rep) : Sq;

  for (int r0 = (r_begin / BQ) * BQ; r0 < r_end; r0 += BQ) {
    __syncthreads();  // previous tile's readers are done
    load_rows<D>(Qs, q, b, r0, BQ, Sq, H, h);
    load_rows<D>(dOs, dout, b, r0, BQ, Sq, H, h);
    __syncthreads();

    const RowInfo ri = row_info(r0, ty, bh, Sq, q_rep, lse, delta);
    float s[4][2], dp[4][2], p[4][2], ds[4][2];
    tile_scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    tile_probs(s, dp, ri, k0, tx, Sk, causal, window, softcap, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p[i][j];
        dSs[(ty * 4 + i) * PS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();  // P and dS tiles complete

    for (int rr = 0; rr < BQ; ++rr) {
      float pk[4], dsk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = Ps[rr * PS + warp * 4 + i];
        dsk[i] = dSs[rr * PS + warp * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float g = __bfloat162float(dOs[rr * DS + lane + 32 * j]);
        const float x = __bfloat162float(Qs[rr * DS + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pk[i], g, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsk[i], x, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + warp * 4 + i;
    if (kk >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kk) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[off + lane + 32 * j] = __float2bfloat16(dk_acc[i][j] * scale);
      dv[off + lane + 32 * j] = __float2bfloat16(dv_acc[i][j]);
    }
  }
}

template <int NJ>  // NJ = D / 16
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Sq, int Sk, int H, int q_rep,
              int causal, int window, float softcap, float scale) {
  constexpr int D = NJ * 16;
  constexpr int DS = D + 2;
  constexpr int NC = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * DS;
  bf16* Ks = dOs + BQ * DS;
  bf16* Vs = Ks + BKV * DS;
  float* dSs = reinterpret_cast<float*>(Vs + BKV * DS);

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * BQ;

  load_rows<D>(Qs, q, b, r0, BQ, Sq, H, h);
  load_rows<D>(dOs, dout, b, r0, BQ, Sq, H, h);
  const RowInfo ri = row_info(r0, ty, bh, Sq, q_rep, lse, delta);

  float dq_acc[8][NC];  // rows warp*8+i, columns lane+32j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dq_acc[i][j] = 0.f;

  // Key range any row of this tile can see (as in the forward).
  const int last_row = min(r0 + BQ, Sq) - 1;
  const int q_lo = r0 / q_rep, q_hi = last_row / q_rep;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int t = k_begin / BKV; t * BKV < k_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's readers are done
    load_rows<D>(Ks, k, b, k0, BKV, Sk, H, h);
    load_rows<D>(Vs, v, b, k0, BKV, Sk, H, h);
    __syncthreads();

    float s[4][2], dp[4][2], p[4][2], ds[4][2];
    tile_scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    tile_probs(s, dp, ri, k0, tx, Sk, causal, window, softcap, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dSs[(ty * 4 + i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();  // dS tile complete

    for (int kk = 0; kk < BKV; ++kk) {
      float dsr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dsr[i] = dSs[(warp * 8 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = __bfloat162float(Ks[kk * DS + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) dq_acc[i][j] = fmaf(dsr[i], kv, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + warp * 8 + i;
    if (r >= Sq) continue;
    const size_t off = (((size_t)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[off + lane + 32 * j] = __float2bfloat16(dq_acc[i][j] * scale);
  }
}

template <int NJ>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Sk, int H, int q_rep,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  constexpr int D = NJ * 16;
  constexpr size_t tile = (size_t)(D + 2) * sizeof(bf16);
  const size_t smem_kv = 2 * BKV * tile + 2 * BQ * tile
                         + 2 * (size_t)BQ * PS * sizeof(float);
  const size_t smem_q = 2 * BQ * tile + 2 * BKV * tile
                        + (size_t)BQ * PS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;

  const int rows = B * Sq * H;
  const int warps = kThreads / 32;
  bwd_delta_kernel<<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(
      o, dout, delta, rows, Sq, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv(B * H, (Sk + BKV - 1) / BKV);
  bwd_dkdv_kernel<NJ><<<grid_kv, kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, q_rep, causal, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q(B * H, (Sq + BQ - 1) / BQ);
  bwd_dq_kernel<NJ><<<grid_q, kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, q_rep, causal, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int D, int q_rep, int causal,
    int window, float softcap, float scale, void* stream) {
  if (B * H == 0 || Sq == 0 || Sk == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define FA_BWD(NJ)                                                           \
  launch<NJ>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),       \
             static_cast<const bf16*>(v), static_cast<const bf16*>(o),       \
             static_cast<const bf16*>(dout), static_cast<const float*>(lse), \
             static_cast<float*>(delta), static_cast<bf16*>(dq),             \
             static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Sk, H,   \
             q_rep, causal, window, softcap, scale, s)
  switch (D) {
    case 64: return FA_BWD(4);
    case 128: return FA_BWD(8);
    case 192: return FA_BWD(12);
    case 256: return FA_BWD(16);
    case 288: return FA_BWD(18);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD
}
