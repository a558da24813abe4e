// Online-softmax (flash) attention forward for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel). Inputs q (B, Sq, H, D), k/v
// (B, Sk, H, D) bf16 with the same head count: GQA callers fold the query
// head group into the rows (q_rep), so folded row r sits at causal position
// r / q_rep. Masks: causal, a sliding window (k > q - window) and keys past
// Sk; masked logits are -1e30 (not -inf), as in the JAX kernel. Logit
// softcap c: s = c * tanh(s / c). Scores, softmax and the output
// accumulator are f32; the output is bf16. An optional f32 output holds
// each row's log-sum-exp (m + log l, shape (B*H, Sq)), which the backward
// kernels (flash_attention_bwd.cu) use to rebuild the probabilities; a
// null pointer skips it (serving).
//
// Bound on this card: operations (2 * 2 * rows * keys * D per head, halved
// by the causal mask). Design, simple first: one CTA of 256 threads per
// (batch*head, 64-row query tile), looping over 64-key tiles held in shared
// memory (Q, K, V tiles in bf16, the probability tile in f32: 128 KB at
// D = 288, so D is a template parameter through D / 16). Each thread owns
// 4 query rows x 4 keys of the score tile and 4 rows x D/16 columns of the
// output accumulator in registers; row max and row sum reduce over the 16
// threads of a row group with warp shuffles. Key tiles that every row of
// the CTA masks out (above the causal diagonal, before the window) are
// skipped, which the JAX kernel's recurrence makes an exact no-op. Scalar
// f32 FMAs, no tensor cores: wgmma and TMA are later work.
#include "sfp_common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;

template <int NJ>  // NJ = D / 16 output columns per thread
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int q_rep, int causal, int window, float softcap,
                       float scale) {
  constexpr int D = NJ * 16;
  constexpr int DS = D + 2;      // padded bf16 row stride of Q and K tiles
  constexpr int PS = BK + 1;     // padded f32 row stride of the P tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * DS;
  __nv_bfloat16* Vs = Ks + BK * DS;
  float* Ps = reinterpret_cast<float*>(Vs + BK * D);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;       // key / column lane within the row group
  const int bh = blockIdx.x;     // b * H + h
  const int b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * BQ;

  // Q tile -> shared (bf16 pairs; rows past Sq are zeros).
  for (int idx = tid; idx < BQ * (D / 2); idx += kThreads) {
    const int r = idx / (D / 2), c = idx % (D / 2);
    uint32_t val = 0u;
    if (r0 + r < Sq)
      val = reinterpret_cast<const uint32_t*>(
          q + (((size_t)b * Sq + r0 + r) * H + h) * D)[c];
    reinterpret_cast<uint32_t*>(Qs + r * DS)[c] = val;
  }

  float acc[4][NJ];
  float m_i[4], l_i[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = SFP_NEG_INF;
    l_i[i] = 0.f;
    qpos[i] = (r0 + ty * 4 + i) / q_rep;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Key range any row of this tile can see.
  const int last_row = min(r0 + BQ, Sq) - 1;
  const int q_lo = r0 / q_rep, q_hi = last_row / q_rep;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int t = k_begin / BK; t * BK < k_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's readers are done
    for (int idx = tid; idx < BK * (D / 2); idx += kThreads) {
      const int r = idx / (D / 2), c = idx % (D / 2);
      uint32_t kv = 0u, vv = 0u;
      if (k0 + r < Sk) {
        const size_t off = (((size_t)b * Sk + k0 + r) * H + h) * D;
        kv = reinterpret_cast<const uint32_t*>(k + off)[c];
        vv = reinterpret_cast<const uint32_t*>(v + off)[c];
      }
      reinterpret_cast<uint32_t*>(Ks + r * DS)[c] = kv;
      reinterpret_cast<uint32_t*>(Vs + r * D)[c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d2 = 0; d2 < D / 2; ++d2) {
      float2 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(Qs + (ty * 4 + i) * DS)[d2]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(Ks + (tx + 16 * j) * DS)[d2]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(qf[i].x, kf[j].x, fmaf(qf[i].y, kf[j].y, s[i][j]));
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mcur = SFP_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && (kp <= qpos[i]);
        if (window > 0) ok = ok && (kp > qpos[i] - window);
        s[i][j] = ok ? x : SFP_NEG_INF;
        mcur = fmaxf(mcur, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, o));
      const float m_new = fmaxf(m_i[i], mcur);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      alpha[i] = expf(m_i[i] - m_new);
      l_i[i] = alpha[i] * l_i[i] + rsum;
      m_i[i] = m_new;
    }
    __syncthreads();  // P tile complete

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = __bfloat162float(Vs[kk * D + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + r] = m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
    __nv_bfloat16* o = out + (((size_t)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
  }
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int q_rep, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int D = NJ * 16;
  const size_t smem = (size_t)BQ * (D + 2) * 2 + (size_t)BK * (D + 2) * 2
                      + (size_t)BK * D * 2 + (size_t)BQ * (BK + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Sq, Sk, H, q_rep, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int D,
                                      int q_rep,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  switch (D) {
    case 64: return launch<4>(q, k, v, out, l, B, Sq, Sk, H, q_rep, causal, window, softcap, scale, s);
    case 128: return launch<8>(q, k, v, out, l, B, Sq, Sk, H, q_rep, causal, window, softcap, scale, s);
    case 192: return launch<12>(q, k, v, out, l, B, Sq, Sk, H, q_rep, causal, window, softcap, scale, s);
    case 256: return launch<16>(q, k, v, out, l, B, Sq, Sk, H, q_rep, causal, window, softcap, scale, s);
    case 288: return launch<18>(q, k, v, out, l, B, Sq, Sk, H, q_rep, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
