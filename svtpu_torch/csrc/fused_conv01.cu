// Fused conv0 -> ReLU -> conv1 -> ReLU of the contrastive encoder trunk,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel svtpu/ops/conv_trunk_pallas.py::_conv1_kernel
// (and _conv1_kernel_multi; both behind fused_conv01) together with its XLA
// prologue conv0_polyphase. It computes what they compute,
//   out = relu(conv1(relu(conv0(x) + b0)) + b1),
// both convs k3/s2/p1 with bias, x [B,256,256,3] NHWC in f32 or bf16,
// out [B,64,64,64] NHWC in the input dtype. The TPU version's polyphase,
// parity-major layout only worked around Mosaic's limits and is not copied:
// here conv0 is fused in.
//
// Rounding follows the TPU path. In bf16, conv0's sum is rounded to bf16,
// the bf16 bias is added and rounded again, then ReLU; conv1 takes bf16
// weights and activations, accumulates in f32, adds an f32 bias, applies
// ReLU and rounds to bf16 once. In f32 everything is f32.
//
// Bound on this card: operations. Per image conv0 is 28M and conv1 151M
// multiply-adds against ~0.4 MB of bf16 input and 0.5 MB of output, far
// above the ~295 operations per byte where the H100 stops being limited by
// memory; at batch 512 the least time is ~0.19 ms at the bf16 tensor-core
// rate. This first version does not reach it: it runs on the CUDA cores in
// f32 (a later version moves conv1 onto the tensor cores with wgmma).
// What its design does about the bound: the only device-memory traffic is
// the input once (plus a small halo), the weights through L1/L2 and the
// output once; conv0's activations never leave shared memory, and every
// thread of conv1 holds a 4-pixel x 8-channel tile of sums in registers, so
// each shared- or global-memory load feeds 8 to 16 multiply-adds.
//
// Work split: one block per (image, 8x8 tile of conv1's output), all 64
// channels. The block stages the 35x35x3 input patch with its halo in shared
// memory, computes the 17x17x64 conv0 tile it needs (ReLU'd, conv1's zero
// padding included) into shared memory, and runs conv1 from there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kImg = 256;              // input H = W
constexpr int kMid = 128;              // conv0 output H = W
constexpr int kOut = 64;               // conv1 output H = W
constexpr int kCh = 64;                // conv0 and conv1 output channels
constexpr int kTile = 8;               // conv1 output tile (rows = cols)
constexpr int kMidT = 2 * kTile + 1;   // 17: conv0 rows/cols a tile needs
constexpr int kInT = 4 * kTile + 3;    // 35: input rows/cols a tile needs
constexpr int kThreads = 128;
constexpr int kTilesPerDim = kOut / kTile;
constexpr size_t kSmemBytes =
    sizeof(float) * kMidT * kMidT * kCh + sizeof(float4) * kInT * kInT;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight consecutive values of T (16- or 32-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// x [B,256,256,3]; w0 [3,3,3,64] and w1 [3,3,64,64] HWIO in T; b0 [64] in T;
// b1 [64] f32; out [B,64,64,64]. blockIdx.x = tile, blockIdx.y = image.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_conv01_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                    const T* __restrict__ b0, const T* __restrict__ w1,
                    const float* __restrict__ b1, T* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* mid = reinterpret_cast<float*>(smem4);               // [17*17][64]
  float4* patch = smem4 + (kMidT * kMidT * kCh) / 4;          // [35*35]

  const int tid = threadIdx.x;
  const long long img = blockIdx.y;
  const int oy0 = (blockIdx.x / kTilesPerDim) * kTile;
  const int ox0 = (blockIdx.x % kTilesPerDim) * kTile;

  // 1. Input patch with halo; zeros outside the image are conv0's padding.
  const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;
  for (int p = tid; p < kInT * kInT; p += kThreads) {
    const int iy = iy0 + p / kInT, ix = ix0 + p % kInT;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (iy >= 0 && iy < kImg && ix >= 0 && ix < kImg) {
      const T* px = x + ((img * kImg + iy) * kImg + ix) * 3;
      v.x = to_f32(px[0]);
      v.y = to_f32(px[1]);
      v.z = to_f32(px[2]);
    }
    patch[p] = v;
  }

  // 2. conv0 tile: thread owns channel c, its 27 weights in registers.
  const int c = tid & (kCh - 1);
  float wr[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) wr[k] = to_f32(w0[k * kCh + c]);
  const float bias0 = to_f32(b0[c]);
  __syncthreads();

  const int mr0 = 2 * oy0 - 1, mc0 = 2 * ox0 - 1;   // tile origin in conv0 output
  for (int pos = tid / kCh; pos < kMidT * kMidT; pos += kThreads / kCh) {
    const int r = pos / kMidT, col = pos % kMidT;
    const int R = mr0 + r, C = mc0 + col;
    float v = 0.f;                                     // conv1's zero padding
    if (R >= 0 && R < kMid && C >= 0 && C < kMid) {
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 a = patch[(2 * r + ky) * kInT + 2 * col + kx];
          const int k = (ky * 3 + kx) * 3;
          acc = fmaf(a.x, wr[k], acc);
          acc = fmaf(a.y, wr[k + 1], acc);
          acc = fmaf(a.z, wr[k + 2], acc);
        }
      }
      v = fmaxf(round_to(round_to(acc, T()) + bias0, T()), 0.f);
    }
    mid[pos * kCh + c] = v;
  }
  __syncthreads();

  // 3. conv1: thread owns 4 pixels (one row, consecutive columns) x 8 channels.
  const int cg = tid & 7, pg = tid >> 3;
  const int py = pg >> 1, px0 = (pg & 1) * 4, co0 = cg * 8;
  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float* arow = mid + ((2 * py + dy) * kMidT + 2 * px0 + dx) * kCh;
      const T* wrow = w1 + (dy * 3 + dx) * kCh * kCh + co0;
#pragma unroll 2
      for (int ci = 0; ci < kCh; ci += 4) {
        float4 a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = *reinterpret_cast<const float4*>(arow + 2 * j * kCh + ci);
        float w[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) load8(wrow + (ci + q) * kCh, w[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float av[4] = {a[j].x, a[j].y, a[j].z, a[j].w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(av[q], w[q][k], acc[j][k]);
        }
      }
    }
  }

  float bias1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bias1[k] = b1[co0 + k];
  const int oy = oy0 + py;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = fmaxf(acc[j][k] + bias1[k], 0.f);
    const int ox = ox0 + px0 + j;
    store8(out + ((img * kOut + oy) * kOut + ox) * kCh + co0, v);
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1,
           const float* b1, void* out, long long batch, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_conv01_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long in_img = (long long)kImg * kImg * 3, out_img = (long long)kOut * kOut * kCh;
  for (long long start = 0; start < batch; start += 65535) {
    const long long n = batch - start < 65535 ? batch - start : 65535;
    dim3 grid(kTilesPerDim * kTilesPerDim, (unsigned)n);
    fused_conv01_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
        static_cast<const T*>(x) + start * in_img, static_cast<const T*>(w0),
        static_cast<const T*>(b0), static_cast<const T*>(w1), b1,
        static_cast<T*>(out) + start * out_img);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int svt_fused_conv01(const void* x, const void* w0, const void* b0,
                                const void* w1, const void* b1, void* out,
                                long long batch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  switch (dtype) {
    case 0: return launch<float>(x, w0, b0, w1, b1f, out, batch, s);
    case 1: return launch<__nv_bfloat16>(x, w0, b0, w1, b1f, out, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
