// Fused Binary-Concrete sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel svtpu/ops/binarize_pallas.py::_kernel
// (binary_concrete_pallas). Per element of the logits:
//   u     = 24 high bits of a Philox4x32-10 draw, times 2^-24  (exact in f32)
//   noise = log(u + eps) - log(1 - u + eps)
//   y     = sigmoid((x + scale * noise) / T)           all in f32
//   out   = hard ? (y > 0.5) : y                       stored in the logits dtype
// The TPU kernel drew its bits from the TPU's on-chip PRNG seeded per grid
// block; here the bits come from a counter-based generator written into the
// kernel: key = the 64-bit seed, counter = (element index / 4), one Philox
// call giving the four 32-bit words of four consecutive elements. The same
// bits are reproduced by the plain PyTorch version in
// svtpu_torch/ops/binarize_cuda.py, so the two can be compared exactly.
//
// Bound on this card: bytes. It reads each logit once and writes one value
// (8 bytes per element in f32); the ~40 integer operations of Philox per
// four elements and two logs and an exp per element stay far under the
// card's rate. On the encode path it sees 512 x latent elements, a few tens
// of KB, so one launch costs its launch latency and nothing more.
// Design: one pass, no shared memory, a grid-stride loop of four-element
// groups; the arithmetic is written with __fadd_rn/__fmul_rn so that the
// compiler does not contract it into FMAs and it rounds as PyTorch's
// separate ops do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__global__ void binary_concrete_kernel(const T* __restrict__ x, T* __restrict__ y,
                                       long long n, unsigned long long seed,
                                       float temp, float scale, float eps,
                                       int hard, int noisy) {
  const long long groups = (n + 3) / 4;
  const uint2 key = make_uint2((unsigned)(seed & 0xffffffffull),
                               (unsigned)(seed >> 32));
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    unsigned bits[4] = {0u, 0u, 0u, 0u};
    if (noisy) {
      const uint4 r = philox4x32_10(
          make_uint4((unsigned)((unsigned long long)g & 0xffffffffull),
                     (unsigned)((unsigned long long)g >> 32), 0u, 0u),
          key);
      bits[0] = r.x; bits[1] = r.y; bits[2] = r.z; bits[3] = r.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * g + j;
      if (i >= n) break;
      float v = to_f32<T>(x[i]);
      if (noisy) {
        const float u = __fmul_rn((float)(bits[j] >> 8), 1.0f / 16777216.0f);
        const float noise = __fsub_rn(logf(__fadd_rn(u, eps)),
                                      logf(__fadd_rn(__fsub_rn(1.0f, u), eps)));
        v = __fadd_rn(v, __fmul_rn(scale, noise));
      }
      const float s = 1.0f / (1.0f + expf(-__fdiv_rn(v, temp)));
      y[i] = from_f32<T>(hard ? (s > 0.5f ? 1.0f : 0.0f) : s);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, unsigned long long seed,
           float temp, float scale, float eps, int hard, int noisy,
           cudaStream_t stream) {
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  binary_concrete_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed, temp, scale, eps,
      hard, noisy);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError().
extern "C" int svt_binary_concrete(const void* x, void* y, long long n, int dtype,
                                   unsigned long long seed, float temp, float scale,
                                   float eps, int hard, int noisy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, n, seed, temp, scale, eps, hard, noisy, s);
    case 1: return launch<__nv_bfloat16>(x, y, n, seed, temp, scale, eps, hard, noisy, s);
    case 2: return launch<__half>(x, y, n, seed, temp, scale, eps, hard, noisy, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
