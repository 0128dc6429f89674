// The RBVAE encoder's stacked LSTM with the Binary-Concrete sampler in its
// epilogue, in one launch, for Hopper (sm_90a).
//
// Replaces, on the post-RNN encode route, the Pallas TPU kernel
// svtpu/ops/binarize_pallas.py::_kernel (binary_concrete_pallas) together
// with the LSTM before it (svtpu/ops/lstm.py:45-85, which the JAX package
// leaves to XLA). It computes exactly what the port's plain route does:
// svtpu_torch/ops/lstm.py::LSTM.forward over all layers (gate order i, f,
// g, o; residual h + LSTM(h) when asked), then the sampler of
// binary_concrete.cu on the last layer's [B, T, H] output, with the same
// Philox key (the seed) and counter (the flat element index), so for a
// given h its codes are bit for bit those of the standalone kernel.
//
// Rounding follows the plain version in the compute dtype T, op by op:
//   gates_x = round(round(x . w_ih[r]) + round(b_ih[r] + b_hh[r]))
//   g       = round(gates_x + round(h_prev . w_hh[r]))
//   i, f, o = round(sigmoid(.)), gc = round(tanh(.))       (ATen's formulas:
//   c       = round(round(f * c) + round(i * gc))           1 / (1 + exp(-v)),
//   h       = round(o * round(tanh(c)))                     tanhf, in f32)
//   out     = residual ? round(input + h) : h
// Weights are the f32 parameters rounded to T, as the plain version casts
// them. The dot products accumulate in f32 with FMAs over k in order; the
// elementwise ops use __fadd_rn/__fmul_rn so that nothing is contracted.
// cuBLAS sums the products in another order, so h can sit one step of T
// away from the plain route in rare elements.
//
// Bound on this card: neither bytes nor operations. At the pixel encode
// ([512, 1, 25], 2 layers) the work is ~10 MFLOP and ~90 KB, a fraction of
// a microsecond at the card's rates; what costs is the chain of dependent
// steps (layers x time steps) and the weights' trip into shared memory.
// Design: a batch row is independent of every other, so a warp owns one
// row and carries it through every layer and time step with no grid-wide
// synchronisation; lane j owns hidden unit j (and j + 32 when H > 32),
// computes its four gates and keeps c in a register; h and the layer input
// go through the warp's slice of shared memory behind __syncwarp. The
// block loads as many layers' weights as fit into shared memory at once,
// each gate row padded to a stride S with S / 4 odd, so that the lanes'
// 16-byte reads of consecutive rows fall in distinct bank groups. An
// intermediate layer's output goes to `seq` ([B, T, H] in device memory,
// where it stays in L2) and is overwritten in place by the next layer; the
// last layer writes `seq` only when the caller asks for h, and always the
// codes. The seed is read from device memory when given a pointer, so the
// host never waits for it; so are the temperature and the noise scale
// when given pointers, so that one CUDA graph of the encode serves every
// temperature.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "binary_concrete.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxH = 64;
constexpr int kWarps = 8;          // batch rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;         // weight loads in flight per thread
constexpr int kSmemBudget = 200 * 1024;

struct LayerWeights {
  const float* w_ih[kMaxLayers];   // [4H, H] row-major (nn.LSTM's weight_ih_l{k})
  const float* w_hh[kMaxLayers];   // [4H, H]
  const float* b_ih[kMaxLayers];   // [4H]
  const float* b_hh[kMaxLayers];   // [4H]
};

struct Shape {
  int H;       // hidden size = input size
  int KP;      // H rounded up to a multiple of 4
  int S;       // a gate row's stride in shared memory: KP or KP + 4, S / 4 odd
  int chunk;   // layers whose weights are resident at once
};

__host__ __device__ inline int layer_floats(const Shape& s) {
  return 2 * 4 * s.H * s.S + 4 * s.H;
}

__host__ __device__ inline int warp_floats(const Shape& s) { return 2 * s.KP; }

__device__ __forceinline__ float sigmoid_f(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// One layer's weights, rounded to T, into shared memory: w_x and w_h as
// [4H][S] (columns H..S-1 stay zero), bias as [4H].
template <typename T>
__device__ void load_layer(float* w_x, float* w_h, float* bias,
                           const LayerWeights& w, int l, const Shape& s) {
  const int H = s.H, n = 4 * H * H;
  const float* wi = w.w_ih[l];
  const float* wh = w.w_hh[l];
  for (int base = threadIdx.x; base < n; base += kUnroll * kThreads) {
    float vx[kUnroll], vh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      vx[u] = e < n ? __ldg(wi + e) : 0.0f;
      vh[u] = e < n ? __ldg(wh + e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      if (e < n) {
        const int r = e / H, k = e - r * H;
        w_x[r * s.S + k] = svt::round_to<T>(vx[u]);
        w_h[r * s.S + k] = svt::round_to<T>(vh[u]);
      }
    }
  }
  for (int r = threadIdx.x; r < 4 * H; r += kThreads)
    bias[r] = svt::round_to<T>(__fadd_rn(__ldg(w.b_ih[l] + r), __ldg(w.b_hh[l] + r)));
}

template <typename T, int UNITS>
__global__ void __launch_bounds__(kThreads)
lstm_binary_concrete_kernel(LayerWeights w, int layers, Shape s,
                            const T* __restrict__ x, T* seq, T* __restrict__ codes,
                            const long long* seed_ptr, unsigned long long seed,
                            int B, int steps, int residual, int write_h,
                            const float* temp_ptr, float temp,
                            const float* scale_ptr, float scale, float eps,
                            int hard, int noisy) {
  extern __shared__ __align__(16) float smem[];
  const int H = s.H, G = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem + s.chunk * layer_floats(s) + warp * warp_floats(s);
  float* hs = xs + s.KP;            // the row's layer input at t; h at t - 1
  const int b = blockIdx.x * kWarps + warp;
  const bool active = b < B;
  const uint2 key = svt::philox_key(noisy ? svt::load_seed(seed_ptr, seed) : 0ull);
  temp = svt::load_scalar(temp_ptr, temp);
  scale = svt::load_scalar(scale_ptr, scale);

  // Zero the padding columns (k >= H) of every resident layer once; the
  // loads never write them.
  for (int c = 0; c < s.chunk; ++c) {
    float* base = smem + c * layer_floats(s);
    for (int e = threadIdx.x; e < 2 * G * (s.S - H); e += kThreads) {
      const int r = e / (s.S - H), k = H + e % (s.S - H);
      base[r * s.S + k] = 0.0f;
    }
  }
  for (int j = lane; j < s.KP; j += 32) xs[j] = hs[j] = 0.0f;

  for (int l = 0; l < layers; ++l) {
    const int slot = l % s.chunk;
    if (slot == 0) {
      __syncthreads();              // every warp is done with the last chunk
      for (int c = 0; c < s.chunk && l + c < layers; ++c) {
        float* base = smem + c * layer_floats(s);
        load_layer<T>(base, base + G * s.S, base + 2 * G * s.S, w, l + c, s);
      }
      __syncthreads();
    }
    if (!active) continue;
    const float* w_x = smem + slot * layer_floats(s);
    const float* w_h = w_x + G * s.S;
    const float* bias = w_h + G * s.S;
    const bool last = l == layers - 1;
    const T* in = l == 0 ? x : seq;
    float c[UNITS];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      c[u] = 0.0f;
      if (lane + 32 * u < H) hs[lane + 32 * u] = 0.0f;
    }
    for (int t = 0; t < steps; ++t) {
      const long long row = ((long long)b * steps + t) * H;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int j = lane + 32 * u;
        if (j < H) xs[j] = svt::to_f32<T>(in[row + j]);
      }
      __syncwarp();                 // xs and hs are whole
      float hn[UNITS];
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int j = lane + 32 * u;
        hn[u] = 0.0f;
        if (j >= H) continue;
        float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ah[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < s.KP; k += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + k);
          const float4 hv = *reinterpret_cast<const float4*>(hs + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 wx = *reinterpret_cast<const float4*>(w_x + (q * H + j) * s.S + k);
            const float4 wh = *reinterpret_cast<const float4*>(w_h + (q * H + j) * s.S + k);
            ax[q] = fmaf(xv.x, wx.x, ax[q]);
            ax[q] = fmaf(xv.y, wx.y, ax[q]);
            ax[q] = fmaf(xv.z, wx.z, ax[q]);
            ax[q] = fmaf(xv.w, wx.w, ax[q]);
            ah[q] = fmaf(hv.x, wh.x, ah[q]);
            ah[q] = fmaf(hv.y, wh.y, ah[q]);
            ah[q] = fmaf(hv.z, wh.z, ah[q]);
            ah[q] = fmaf(hv.w, wh.w, ah[q]);
          }
        }
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float gx = svt::round_to<T>(
              __fadd_rn(svt::round_to<T>(ax[q]), bias[q * H + j]));
          g[q] = svt::round_to<T>(__fadd_rn(gx, svt::round_to<T>(ah[q])));
        }
        const float gi = svt::round_to<T>(sigmoid_f(g[0]));
        const float gf = svt::round_to<T>(sigmoid_f(g[1]));
        const float gc = svt::round_to<T>(tanhf(g[2]));
        const float go = svt::round_to<T>(sigmoid_f(g[3]));
        c[u] = svt::round_to<T>(__fadd_rn(svt::round_to<T>(__fmul_rn(gf, c[u])),
                                          svt::round_to<T>(__fmul_rn(gi, gc))));
        hn[u] = svt::round_to<T>(__fmul_rn(go, svt::round_to<T>(tanhf(c[u]))));
      }
      __syncwarp();                 // every lane has read xs and hs
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int j = lane + 32 * u;
        if (j >= H) continue;
        hs[j] = hn[u];
        const float out = residual ? svt::round_to<T>(__fadd_rn(xs[j], hn[u])) : hn[u];
        const long long i = row + j;
        if (!last || write_h) seq[i] = svt::from_f32<T>(out);
        if (last) {
          unsigned bits = 0u;
          if (noisy) {
            const uint4 r = svt::philox_group((unsigned long long)i >> 2, key);
            const int word = (int)(i & 3);
            bits = word == 0 ? r.x : word == 1 ? r.y : word == 2 ? r.z : r.w;
          }
          codes[i] = svt::from_f32<T>(
              svt::binary_concrete_value(out, bits, temp, scale, eps, hard, noisy));
        }
      }
    }
  }
}

template <typename T>
int launch(const LayerWeights& w, int layers, int H, const void* x, void* seq,
           void* codes, const long long* seed_ptr, unsigned long long seed,
           int B, int steps, int residual, int write_h, const float* temp_ptr,
           float temp, const float* scale_ptr, float scale, float eps,
           int hard, int noisy, cudaStream_t stream) {
  Shape s;
  s.H = H;
  s.KP = (H + 3) / 4 * 4;
  s.S = (s.KP / 4) % 2 ? s.KP : s.KP + 4;
  const int fixed = kWarps * warp_floats(s);
  s.chunk = (kSmemBudget / 4 - fixed) / layer_floats(s);
  if (s.chunk > layers) s.chunk = layers;
  if (s.chunk < 1) return (int)cudaErrorInvalidValue;
  const int smem = 4 * (s.chunk * layer_floats(s) + fixed);
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  cudaError_t e;
  if (H > 32) {
    e = cudaFuncSetAttribute(lstm_binary_concrete_kernel<T, 2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    lstm_binary_concrete_kernel<T, 2><<<blocks, kThreads, smem, stream>>>(
        w, layers, s, static_cast<const T*>(x), static_cast<T*>(seq),
        static_cast<T*>(codes), seed_ptr, seed, B, steps, residual, write_h,
        temp_ptr, temp, scale_ptr, scale, eps, hard, noisy);
  } else {
    e = cudaFuncSetAttribute(lstm_binary_concrete_kernel<T, 1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    lstm_binary_concrete_kernel<T, 1><<<blocks, kThreads, smem, stream>>>(
        w, layers, s, static_cast<const T*>(x), static_cast<T*>(seq),
        static_cast<T*>(codes), seed_ptr, seed, B, steps, residual, write_h,
        temp_ptr, temp, scale_ptr, scale, eps, hard, noisy);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// w_ih, w_hh, b_ih, b_hh: host arrays of `layers` device pointers to the
// float32 parameters of nn.LSTM (weight_ih_l{k} [4H, H], weight_hh_l{k}
// [4H, H], bias_ih_l{k} [4H], bias_hh_l{k} [4H]). x: [B, steps, H] in the
// compute dtype (0 = float32, 1 = bfloat16). seq: [B, steps, H] scratch
// for the intermediate layers and, with write_h, the last layer's output;
// may be null when layers == 1 and not write_h. codes: [B, steps, H].
// seed_ptr: a one-element int64 in device memory holding the seed, or null
// to use `seed`. temp_ptr, scale_ptr: a float32 in device memory holding
// the temperature or the noise scale, or null to use `temp` or `scale`.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int svt_lstm_binary_concrete(
    const void* const* w_ih, const void* const* w_hh, const void* const* b_ih,
    const void* const* b_hh, int layers, int H, const void* x, void* seq,
    void* codes, const void* seed_ptr, unsigned long long seed, int B,
    int steps, int dtype, int residual, int write_h, const void* temp_ptr,
    float temp, const void* scale_ptr, float scale, float eps, int hard,
    int noisy, void* stream) {
  if (layers < 1 || layers > kMaxLayers || H < 1 || H > kMaxH || B < 1 ||
      steps < 1 || ((layers > 1 || write_h) && seq == nullptr))
    return (int)cudaErrorInvalidValue;
  LayerWeights w;
  for (int l = 0; l < layers; ++l) {
    w.w_ih[l] = static_cast<const float*>(w_ih[l]);
    w.w_hh[l] = static_cast<const float*>(w_hh[l]);
    w.b_ih[l] = static_cast<const float*>(b_ih[l]);
    w.b_hh[l] = static_cast<const float*>(b_hh[l]);
  }
  for (int l = layers; l < kMaxLayers; ++l)
    w.w_ih[l] = w.w_hh[l] = w.b_ih[l] = w.b_hh[l] = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(seed_ptr);
  const float* tp = static_cast<const float*>(temp_ptr);
  const float* cp = static_cast<const float*>(scale_ptr);
  switch (dtype) {
    case 0: return launch<float>(w, layers, H, x, seq, codes, sp, seed, B, steps,
                                 residual, write_h, tp, temp, cp, scale, eps,
                                 hard, noisy, s);
    case 1: return launch<__nv_bfloat16>(w, layers, H, x, seq, codes, sp, seed, B,
                                         steps, residual, write_h, tp, temp, cp,
                                         scale, eps, hard, noisy, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
