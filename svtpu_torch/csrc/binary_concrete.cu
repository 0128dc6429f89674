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
// The seed is read from device memory when the wrapper passes a pointer to
// it (a seed drawn on the card never visits the host), else taken from the
// launch; so are the temperature and the noise scale, which a CUDA graph of
// the encode reads from tensors the caller writes before each replay. The per-element arithmetic lives in binary_concrete.cuh, which
// the encoder LSTM's fused sampler (lstm_binary_concrete.cu) shares.
//
// Bound on this card: bytes. It reads each logit once and writes one value
// (8 bytes per element in f32); the ~40 integer operations of Philox per
// four elements and two logs and an exp per element stay far under the
// card's rate. On the encode path it sees 512 x latent elements, a few tens
// of KB, so one launch costs its launch latency and nothing more.
// Design: one pass, no shared memory, a grid-stride loop of four-element
// groups, one Philox call per group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "binary_concrete.cuh"

namespace {

template <typename T>
__global__ void binary_concrete_kernel(const T* __restrict__ x, T* __restrict__ y,
                                       long long n, const long long* seed_ptr,
                                       unsigned long long seed,
                                       const float* temp_ptr, float temp,
                                       const float* scale_ptr, float scale,
                                       float eps, int hard, int noisy) {
  const long long groups = (n + 3) / 4;
  const uint2 key = svt::philox_key(noisy ? svt::load_seed(seed_ptr, seed) : 0ull);
  temp = svt::load_scalar(temp_ptr, temp);
  scale = svt::load_scalar(scale_ptr, scale);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    unsigned bits[4] = {0u, 0u, 0u, 0u};
    if (noisy) {
      const uint4 r = svt::philox_group((unsigned long long)g, key);
      bits[0] = r.x; bits[1] = r.y; bits[2] = r.z; bits[3] = r.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * g + j;
      if (i >= n) break;
      y[i] = svt::from_f32<T>(svt::binary_concrete_value(
          svt::to_f32<T>(x[i]), bits[j], temp, scale, eps, hard, noisy));
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, const long long* seed_ptr,
           unsigned long long seed, const float* temp_ptr, float temp,
           const float* scale_ptr, float scale, float eps, int hard,
           int noisy, cudaStream_t stream) {
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  binary_concrete_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed_ptr, seed,
      temp_ptr, temp, scale_ptr, scale, eps, hard, noisy);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. seed_ptr: a one-element
// int64 in device memory holding the seed, or null to use `seed`. temp_ptr,
// scale_ptr: a float32 in device memory holding the temperature or the
// noise scale, or null to use `temp` or `scale`. Returns cudaGetLastError().
extern "C" int svt_binary_concrete(const void* x, void* y, long long n, int dtype,
                                   const void* seed_ptr, unsigned long long seed,
                                   const void* temp_ptr, float temp,
                                   const void* scale_ptr, float scale, float eps,
                                   int hard, int noisy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(seed_ptr);
  const float* tp = static_cast<const float*>(temp_ptr);
  const float* cp = static_cast<const float*>(scale_ptr);
  switch (dtype) {
    case 0: return launch<float>(x, y, n, sp, seed, tp, temp, cp, scale, eps, hard, noisy, s);
    case 1: return launch<__nv_bfloat16>(x, y, n, sp, seed, tp, temp, cp, scale, eps, hard, noisy, s);
    case 2: return launch<__half>(x, y, n, sp, seed, tp, temp, cp, scale, eps, hard, noisy, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
