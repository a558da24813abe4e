// Mantissa truncation Q(M, n) (paper eq. 5) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mantissa_quant.py:
// mantissa_quantize (_quant_kernel). Keeps the sign, the exponent and the
// top n mantissa bits of every bf16 or f32 value and zeroes the rest; n is
// read from device memory (a bitlength drawn on the card needs no host
// sync) and clamped to [0, man_bits].
//
// Bound on this card: memory (each 2- or 4-byte word is read once and
// written once). Design: a grid-stride pass over 16-byte vectors, with the
// 16- or 32-bit mask replicated across each 32-bit lane of the vector, so
// both container widths run the same loop; the ragged tail (fewer than one
// vector) is masked element by element.
#include "sfp_common.cuh"

namespace {

template <typename T>
__global__ void mantissa_quant_kernel(const T* __restrict__ x,
                                      T* __restrict__ out, long long n,
                                      const int* __restrict__ bits_ptr) {
  constexpr int kBits = sizeof(T) * 8;
  constexpr int man_bits = kBits == 16 ? 7 : 23;
  constexpr uint32_t word_mask = kBits == 16 ? 0xFFFFu : 0xFFFFFFFFu;
  const uint32_t m = (word_mask & ~((1u << man_bits) - 1u))
                     | sfp_keep_mask(*bits_ptr, man_bits);
  const uint32_t m32 = kBits == 16 ? (m | (m << 16)) : m;
  constexpr long long kPerVec = 16 / sizeof(T);
  const long long n_vec = n / kPerVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    uint4 w = xv[i];
    w.x &= m32; w.y &= m32; w.z &= m32; w.w &= m32;
    ov[i] = w;
  }
  for (long long i = n_vec * kPerVec + tid; i < n; i += stride)
    out[i] = (T)((uint32_t)x[i] & m);
}

template <typename T>
int launch(const void* x, void* out, long long n, const int* bits,
           cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long vecs = n / (16 / (long long)sizeof(T)) + 1;
  long long blocks = (vecs + kThreads - 1) / kThreads;
  blocks = blocks < 132 * 16 ? blocks : 132 * 16;  // 16 blocks per SM
  mantissa_quant_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mantissa_quantize_launch(const void* x, const void* bits,
                                        void* out, long long n, int src_bits,
                                        void* stream) {
  if (n <= 0) return 0;
  if (bits == nullptr) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int*>(bits);
  if (src_bits == 16) return launch<uint16_t>(x, out, n, b, s);
  if (src_bits == 32) return launch<uint32_t>(x, out, n, b, s);
  return (int)cudaErrorInvalidValue;
}
