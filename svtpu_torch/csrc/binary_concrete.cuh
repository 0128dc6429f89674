// The Binary-Concrete sampler's per-element arithmetic, shared by the
// standalone sampler (binary_concrete.cu) and the encoder LSTM with the
// sampler in its epilogue (lstm_binary_concrete.cu), so that both give the
// same bits for the same value, seed and element index.
//
// Element i of a contiguous tensor takes word (i % 4) of the Philox4x32-10
// draw of counter (i / 4, 0, 0, 0) under the 64-bit key `seed`; its
// uniform is that word's 24 high bits times 2^-24 (exact in f32). The
// arithmetic is written with __fadd_rn/__fmul_rn so that the compiler does
// not contract it into FMAs and it rounds as PyTorch's separate ops do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace svt {

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

__device__ __forceinline__ uint2 philox_key(unsigned long long seed) {
  return make_uint2((unsigned)(seed & 0xffffffffull), (unsigned)(seed >> 32));
}

// The four words of group g (elements 4g .. 4g+3).
__device__ __forceinline__ uint4 philox_group(unsigned long long g, uint2 key) {
  return philox4x32_10(
      make_uint4((unsigned)(g & 0xffffffffull), (unsigned)(g >> 32), 0u, 0u),
      key);
}

// The seed: read from device memory when the caller gave a pointer (so the
// host never has to know it), else the value passed with the launch.
__device__ __forceinline__ unsigned long long load_seed(const long long* seed_ptr,
                                                        unsigned long long seed) {
  return seed_ptr ? (unsigned long long)__ldg(seed_ptr) : seed;
}

// A scalar argument (the temperature, the noise scale): read from device
// memory when the caller gave a pointer, else the value passed with the
// launch. A CUDA graph bakes a launch's values in; a pointer lets one
// graph serve every value the caller writes there between replays.
__device__ __forceinline__ float load_scalar(const float* ptr, float value) {
  return ptr ? __ldg(ptr) : value;
}

// y = sigmoid((v + scale * logistic(u)) / temp) in f32, then the 0.5
// threshold if `hard`. `bits` is the element's Philox word (unused when
// not `noisy`).
__device__ __forceinline__ float binary_concrete_value(float v, unsigned bits,
                                                       float temp, float scale,
                                                       float eps, int hard,
                                                       int noisy) {
  if (noisy) {
    const float u = __fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f);
    const float noise = __fsub_rn(logf(__fadd_rn(u, eps)),
                                  logf(__fadd_rn(__fsub_rn(1.0f, u), eps)));
    v = __fadd_rn(v, __fmul_rn(scale, noise));
  }
  const float s = 1.0f / (1.0f + expf(-__fdiv_rn(v, temp)));
  return hard ? (s > 0.5f ? 1.0f : 0.0f) : s;
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

// v rounded to T and back: where PyTorch stores an op's result in T.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

}  // namespace svt
