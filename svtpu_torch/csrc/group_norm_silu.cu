// GroupNorm(32) with an optional SiLU over channels-last activations, for
// Hopper (sm_90a): the norms of the SD first stage's encoder and decoder
// (models/autoencoder_kl.py, GroupNormSiLU).
//
// Replaces no TPU kernel: svtpu runs this norm as XLA ops
// (svtpu/models/autoencoder_kl.py, GroupNormSiLU: NHWC, f32 statistics).
// It was added because the norm is bound by memory and, run as PyTorch's
// separate passes (a cast to f32, an NCHW copy for F.group_norm, the norm,
// SiLU, a cast back), it took most of the SD encoder's device time: ~20
// bytes of traffic an element where the least is 4.
//
// The function, per frame b and group g of C / 32 consecutive channels:
//   mean, var = biased moments of x over the group's H W C / 32 elements (f32)
//   a_c = gamma_c / sqrt(var + eps),  s_c = beta_c - mean a_c
//   y = x a_c + s_c, then y / (1 + exp(-y)) with SiLU, rounded once to
//   the input's dtype (bf16 or f32), in the input's channels-last layout.
//
// Bound on this card: bytes. One read and one write an element are the
// least (4 bytes in bf16); the statistics need the whole group before the
// first output, and a level-0 tensor of the SD encoder at 8 x 704 x 1280
// is 1.84 GB, far over the 50 MB L2, so the design reads twice (6 bytes an
// element in bf16): at most 67% of the bytes bound.
//
// Design (three launches, named for their traces):
// - group_norm_silu_stats_kernel: a block takes a tile of whole pixels of
//   one frame ([pixels, C], C contiguous). Each thread keeps one 16-byte
//   column of channels (8 bf16 or 4 f32) and walks the tile's pixels, four
//   16-byte loads in flight, neighbouring threads on neighbouring
//   addresses. A vector's elements of one group are reduced exactly in
//   registers and merged into the thread's running (mean, M2) by Chan's
//   formula; then one thread a group merges the block's partials, in a
//   fixed order, and writes (mean, M2) for the tile.
// - group_norm_silu_merge_kernel: a warp a (frame, group) merges the
//   tiles' partials by Chan's formula, a lane over every 32nd tile, then a
//   butterfly in which both lanes of a pair merge (lower, upper): the same
//   order on every run, so two runs give the same bits. No float atomics;
//   no E[x^2] - mean^2, which loses the variance in f32 over a group of
//   3.6 M elements.
// - group_norm_silu_kernel: the same tiling; each thread computes a_c and
//   s_c for its 16-byte column once, then one FMA (and SiLU) an element,
//   16-byte loads (streaming: x is not read again) and stores. It walks
//   the tiles in the reverse order of the statistics pass, so its first
//   tiles are those that pass read last and may still find them in L2.
// The wrapper (ops/group_norm.py) picks the tile (pixels a block) from the
// shape, so that small levels still fill the card, and allocates the
// scratch: partials [B, tiles, 32] and statistics [B, 32] of float2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 32;
constexpr int kThreads = 256;

// 16 bytes of T as floats, and back (rounded to nearest even).
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// Chan et al.'s merge of (nb, meanb, m2b) into (n, mean, m2): the moments
// of the union. Exact in the count; the same operands in the same order
// give the same bits.
__device__ __forceinline__ void merge(float& n, float& mean, float& m2,
                                      float nb, float meanb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float delta = meanb - mean;
  const float rb = nb / nn;
  mean += delta * rb;
  m2 += m2b + delta * delta * n * rb;
  n = nn;
}

template <typename T, int CPG>
__global__ void __launch_bounds__(kThreads)
group_norm_silu_stats_kernel(const T* __restrict__ x, float2* __restrict__ part,
                             int hw, int c, int tile_px) {
  constexpr int V = Vec<T>::N;
  constexpr int M = V < CPG ? V : CPG;  // a group's elements in one vector
  constexpr int GV = V / M;             // groups one vector touches
  constexpr int CH = CPG / M;           // vectors' chunks a group spans in a pixel
  __shared__ float2 s_part[kThreads * GV];

  const int vpr = c / V;                // vectors a pixel
  const int rows = kThreads / vpr;      // pixels a step
  const int col = threadIdx.x % vpr, row = threadIdx.x / vpr;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int p0 = tile * tile_px, p1 = min(p0 + tile_px, hw);
  const T* src = x + (size_t)b * hw * c + col * V;

  float mean[GV], m2[GV];
#pragma unroll
  for (int g = 0; g < GV; ++g) mean[g] = m2[g] = 0.f;
  int k = 0;  // vectors merged so far
  auto add = [&](const uint4& r) {
    float v[V];
    Vec<T>::unpack(r, v);
    ++k;
    const float rk = 1.f / (float)k;
    const float wk = (float)M * (float)(k - 1) * rk;
#pragma unroll
    for (int g = 0; g < GV; ++g) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) s += v[g * M + j];
      const float mb = s * (1.f / M);
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float d = v[g * M + j] - mb;
        q += d * d;
      }
      const float delta = mb - mean[g];
      mean[g] += delta * rk;
      m2[g] += q + delta * delta * wk;
    }
  };
  int p = p0 + row;
  for (; p + 3 * rows < p1; p += 4 * rows) {
    uint4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      r[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(p + u * rows) * c));
#pragma unroll
    for (int u = 0; u < 4; ++u) add(r[u]);
  }
  for (; p < p1; p += rows)
    add(__ldg(reinterpret_cast<const uint4*>(src + (size_t)p * c)));

  const int chunks = vpr * GV;          // chunks a pixel: c / M
#pragma unroll
  for (int g = 0; g < GV; ++g)
    s_part[row * chunks + col * GV + g] = make_float2(mean[g], m2[g]);
  __syncthreads();
  if (threadIdx.x < kGroups) {
    const int g = threadIdx.x;
    float n = 0.f, mu = 0.f, q = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int left = p1 - p0 - r;     // the tile's pixels from row r on
      if (left <= 0) break;
      const float nr = (float)(((left + rows - 1) / rows) * M);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float2 e = s_part[r * chunks + g * CH + j];
        merge(n, mu, q, nr, e.x, e.y);
      }
    }
    part[((size_t)b * gridDim.x + tile) * kGroups + g] = make_float2(mu, q);
  }
}

__global__ void __launch_bounds__(kGroups * 32)
group_norm_silu_merge_kernel(const float2* __restrict__ part,
                             float2* __restrict__ stats, int hw, int cpg,
                             int tile_px, int tiles, float eps) {
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32, b = blockIdx.x;
  const float2* src = part + (size_t)b * tiles * kGroups + g;
  float n = 0.f, mu = 0.f, q = 0.f;
  for (int t = lane; t < tiles; t += 32) {
    const int px = min(tile_px, hw - t * tile_px);
    const float2 e = src[(size_t)t * kGroups];
    merge(n, mu, q, (float)px * (float)cpg, e.x, e.y);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n2 = __shfl_xor_sync(0xffffffffu, n, off);
    const float mu2 = __shfl_xor_sync(0xffffffffu, mu, off);
    const float q2 = __shfl_xor_sync(0xffffffffu, q, off);
    const bool lower = (lane & off) == 0;
    float na = lower ? n : n2, ma = lower ? mu : mu2, qa = lower ? q : q2;
    merge(na, ma, qa, lower ? n2 : n, lower ? mu2 : mu, lower ? q2 : q);
    n = na;
    mu = ma;
    q = qa;
  }
  if (lane == 0)
    stats[b * kGroups + g] = make_float2(mu, 1.f / sqrtf(q / n + eps));
}

template <typename T, int CPG, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_silu_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float2* __restrict__ stats,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, int hw, int c,
                       int tile_px) {
  constexpr int V = Vec<T>::N;
  const int vpr = c / V, rows = kThreads / vpr;
  const int col = threadIdx.x % vpr, row = threadIdx.x / vpr;
  // The reverse of the statistics pass's order (see the header).
  const int tile = gridDim.x - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;
  const int p0 = tile * tile_px, p1 = min(p0 + tile_px, hw);

  float a[V], s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = col * V + j;
    const float2 st = stats[b * kGroups + ch / CPG];
    a[j] = st.y * gamma[ch];
    s[j] = beta[ch] - st.x * a[j];
  }
  const size_t base = (size_t)b * hw * c + col * V;
  auto apply = [&](const uint4& r, size_t at) {
    float v[V];
    Vec<T>::unpack(r, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = fmaf(v[j], a[j], s[j]);
      v[j] = SILU ? __fdividef(t, 1.f + __expf(-t)) : t;
    }
    *reinterpret_cast<uint4*>(y + at) = Vec<T>::pack(v);
  };
  int p = p0 + row;
  for (; p + 3 * rows < p1; p += 4 * rows) {
    uint4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      r[u] = __ldcs(reinterpret_cast<const uint4*>(x + base + (size_t)(p + u * rows) * c));
#pragma unroll
    for (int u = 0; u < 4; ++u) apply(r[u], base + (size_t)(p + u * rows) * c);
  }
  for (; p < p1; p += rows)
    apply(__ldcs(reinterpret_cast<const uint4*>(x + base + (size_t)p * c)),
          base + (size_t)p * c);
}

template <typename T, int CPG>
cudaError_t launch(const void* x, void* y, const float* gamma,
                   const float* beta, void* part, void* stats, int batch,
                   int hw, int c, int tile_px, int silu, float eps,
                   cudaStream_t stream) {
  const int tiles = (hw + tile_px - 1) / tile_px;
  const dim3 grid(tiles, batch);
  const T* xt = static_cast<const T*>(x);
  float2* pt = static_cast<float2*>(part);
  float2* st = static_cast<float2*>(stats);
  group_norm_silu_stats_kernel<T, CPG><<<grid, kThreads, 0, stream>>>(
      xt, pt, hw, c, tile_px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_norm_silu_merge_kernel<<<batch, kGroups * 32, 0, stream>>>(
      pt, st, hw, CPG, tile_px, tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    group_norm_silu_kernel<T, CPG, true><<<grid, kThreads, 0, stream>>>(
        xt, static_cast<T*>(y), st, gamma, beta, hw, c, tile_px);
  else
    group_norm_silu_kernel<T, CPG, false><<<grid, kThreads, 0, stream>>>(
        xt, static_cast<T*>(y), st, gamma, beta, hw, c, tile_px);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cpg(const void* x, void* y, const float* gamma,
                       const float* beta, void* part, void* stats, int batch,
                       int hw, int c, int tile_px, int silu, float eps,
                       cudaStream_t stream) {
  switch (c / kGroups) {
    case 1: return launch<T, 1>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, stream);
    case 2: return launch<T, 2>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, stream);
    case 4: return launch<T, 4>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, stream);
    case 8: return launch<T, 8>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, stream);
    case 16: return launch<T, 16>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [batch, hw, c] (channels-last), 16-byte aligned; dtype 0 f32, 1
// bf16; c = 32 x {1, 2, 4, 8, 16}; gamma, beta: [c] f32; part: [batch,
// tiles, 32] float2 and stats: [batch, 32] float2 scratch, tiles =
// ceil(hw / tile_px); tile_px a multiple of the pixels a step (256 x
// 16 / (c x sizeof(T))). Returns cudaGetLastError() after the launches.
extern "C" int svt_group_norm_silu(const void* x, void* y, const float* gamma,
                                   const float* beta, void* part, void* stats,
                                   int batch, int hw, int c, int tile_px,
                                   int dtype, int silu, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_cpg<float>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, s);
  if (dtype == 1)
    return (int)launch_cpg<__nv_bfloat16>(x, y, gamma, beta, part, stats, batch, hw, c, tile_px, silu, eps, s);
  return (int)cudaErrorInvalidValue;
}
