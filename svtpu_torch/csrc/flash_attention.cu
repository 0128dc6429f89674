// Non-causal single-head attention, softmax(q k^T / sqrt(D)) v, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel svtpu/ops/attention.py::_flash_kernel
// (flash_attention). It computes what that kernel computes, with its
// rounding: q and k in the input dtype, q k^T accumulated in f32 and scaled
// in f32; an online softmax over key tiles whose running max starts at
// -1e30 and whose denominator l sums the unrounded f32 p; p rounded to the
// input dtype before the p v product, which accumulates in f32; the output
// acc / l cast once to the input dtype. q, k, v, out are [B, N, D]
// row-major; D is a multiple of 32 up to 512; N is any length: keys past N
// are masked to -inf inside the kernel and query rows past N are not
// stored. The TPU kernel's (256, 1408) blocks only suited VMEM and are not
// copied.
//
// Bound on this card: operations. At the SD bottleneck (B = 8, N = 14,080,
// D = 512) the two products are 4 B N^2 D = 3.25 TFLOP against 0.46 GB of
// q, k, v and out: 3.28 ms at the bf16 tensor-core rate, 0.14 ms of bytes.
//
// D = 512 is the difficulty: one query tile's f32 accumulator [64, 512] is
// 128 KB, too much for one thread's registers and most of a block's shared
// memory. The design splits the output width across the 8 warps of one
// block, not across blocks: each warp holds all 64 rows x D/8 columns of the
// accumulator in registers (128 f32 a thread at D = 512), the scores of a
// key tile are computed once per block (each warp a 16 x 32 piece, over the
// whole D) and shared through shared memory. So the work is exactly
// 4 B N^2 D FLOPs; splitting the width across blocks instead would
// recompute q k^T once per split, (2 + 2 s) B N^2 D FLOPs, 2.5x at s = 4.
// Shared memory holds the q, k and v tiles (64 rows of D padded to a
// multiple of 64, plus 8 to spread the banks), the f32 score tile and the
// bf16 p tile: 227,840 bytes at D = 512, within the 227 KB a block may have
// after cudaFuncSetAttribute, so one block of 256 threads runs per SM.
// Products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate). This first version loads each tile synchronously and
// overlaps nothing; wgmma, TMA and a pipelined persistent grid are later
// work.
//
// f32 inputs take a second, plain kernel on the CUDA cores (32 x 32 tiles,
// f32 FMAs, p kept in f32 as the TPU kernel's p.astype(float32) does), used
// by the f32 parity checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInit = -1e30f;  // the running max's start, as on the TPU
constexpr int kThreads = 256;

// ------------------------------------------------------------ shared pieces

// One key tile of the online softmax for one query row, shared by TPR
// consecutive lanes; lane `sub` of the group holds the raw dot products of
// keys sub + i * TPR in s[]. Keys at or past `valid` are masked. Updates the
// running max m and denominator l (equal in all TPR lanes), leaves the
// unrounded p in s[] and returns the rescale factor alpha.
template <int PER, int TPR>
__device__ __forceinline__ float online_softmax(float* s, int sub, int valid,
                                                float scale, float& m,
                                                float& l) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    s[i] = sub + i * TPR < valid ? __fmul_rn(s[i], scale) : -INFINITY;
    mx = fmaxf(mx, s[i]);
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    s[i] = expf(s[i] - m_new);
    sum += s[i];
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  l = l * alpha + sum;
  m = m_new;
  return alpha;
}

// ------------------------------------------------- bf16: tensor-core kernel

constexpr int kBQ = 64;         // query rows of a block
constexpr int kBK = 64;         // keys of a tile
constexpr int kSP = kBK + 8;    // score tile pitch (floats)
constexpr int kPP = kBK + 8;    // p tile pitch (bf16)
static_assert(kBQ == kBK, "load_tile_bf16 copies kBQ rows of q, k and v");

__host__ __device__ constexpr int pad64(int d) { return (d + 63) / 64 * 64; }

size_t bf16_smem_bytes(int D) {
  const int pitch = pad64(D) + 8;
  return 3ull * kBQ * pitch * 2 + (size_t)kBQ * kSP * 4 +
         (size_t)kBQ * kPP * 2 + 2ull * kBQ * 4;
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// d (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [row0, row0 + 64) of one [N, D] bf16 matrix into shared memory rows
// of `pitch` elements; rows past N and columns past D are zeros.
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* src, int row0,
                                               int N, int D, int pitch) {
  const int chunks = pad64(D) / 8;  // 16-byte pieces of a padded row
  for (int i = threadIdx.x; i < kBQ * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < N && c < D)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c));
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

// grid (ceil(N / 64), B), 256 threads. Fragment layouts are those of
// mma.m16n8k16 (PTX ISA): lane = 4 g + t; A holds rows g, g+8 and columns
// 2t, 2t+1, 2t+8, 2t+9; B holds k rows 2t, 2t+1, 2t+8, 2t+9 of column g;
// C holds rows g, g+8 and columns 2t, 2t+1.
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                  int N, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = pad64(D), pitch = Dp + 8;
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Ks = Qs + kBQ * pitch;
  uint16_t* Vs = Ks + kBK * pitch;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * pitch);
  uint16_t* Ps = reinterpret_cast<uint16_t*>(Ss + kBQ * kSP);
  float* alpha_s = reinterpret_cast<float*>(Ps + kBQ * kPP);
  float* l_s = alpha_s + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * kBQ;
  load_tile_bf16(Qs, q + base, q0, N, D, pitch);

  // Scores: warp computes rows sm0..sm0+15 x keys sn0..sn0+31 of the tile.
  const int sm0 = (warp & 3) * 16, sn0 = (warp >> 2) * 32;
  // Softmax: 4 lanes per query row, lane `ssub` takes keys ssub + 4 i.
  const int srow = tid >> 2, ssub = tid & 3;
  float m = kNegInit, l = 0.f;
  // Output: warp owns all 64 rows x columns c0 .. c0 + Dp/8 - 1,
  // in 4 row tiles x `ntiles` column tiles of 16 x 8.
  const int ntiles = Dp / 64, c0 = warp * (Dp / 8);
  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    load_tile_bf16(Ks, k + base, k0, N, D, pitch);
    load_tile_bf16(Vs, v + base, k0, N, D, pitch);
    __syncthreads();

    // 1. s = q k^T over the whole (padded) D, f32 accumulation.
    float sacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    for (int d0 = 0; d0 < Dp; d0 += 16) {
      const uint16_t* qa = Qs + (sm0 + g) * pitch + d0 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * pitch), ld32(qa + 8),
                             ld32(qa + 8 * pitch + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint16_t* kb = Ks + (sn0 + 8 * j + g) * pitch + d0 + 2 * t;
        const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(sacc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* sp = Ss + (sm0 + g) * kSP + sn0 + 8 * j + 2 * t;
      sp[0] = sacc[j][0];
      sp[1] = sacc[j][1];
      sp[8 * kSP] = sacc[j][2];
      sp[8 * kSP + 1] = sacc[j][3];
    }
    __syncthreads();

    // 2. Online softmax of the tile; p rounded to bf16 for the product.
    {
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = Ss[srow * kSP + ssub + 4 * i];
      const float alpha = online_softmax<16, 4>(s, ssub, N - k0, scale, m, l);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        Ps[srow * kPP + ssub + 4 * i] =
            __bfloat16_as_ushort(__float2bfloat16_rn(s[i]));
      if (ssub == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // 3. acc = acc * alpha + p v.
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float a_lo = alpha_s[16 * mt + g], a_hi = alpha_s[16 * mt + g + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < ntiles) {
          acc[mt][nt][0] *= a_lo;
          acc[mt][nt][1] *= a_lo;
          acc[mt][nt][2] *= a_hi;
          acc[mt][nt][3] *= a_hi;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < ntiles) {
          const uint16_t* vb = Vs + (kk + 2 * t) * pitch + c0 + 8 * nt + g;
          b[nt][0] = pack(vb[0], vb[pitch]);
          b[nt][1] = pack(vb[8 * pitch], vb[9 * pitch]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint16_t* pa = Ps + (16 * mt + g) * kPP + kk + 2 * t;
        const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * kPP), ld32(pa + 8),
                               ld32(pa + 8 * kPP + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          if (nt < ntiles) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
    __syncthreads();
  }

  if (ssub == 0) l_s[srow] = l;
  __syncthreads();

  // out = acc / l, rounded once to bf16; rows past N are not stored.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + g + 8 * h;
      if (q0 + row >= N) continue;
      const float lrow = l_s[row];
      uint16_t* orow = out + base + (size_t)(q0 + row) * D;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c0 + 8 * nt + 2 * t;
        if (nt < ntiles && col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[mt][nt][2 * h] / lrow, acc[mt][nt][2 * h + 1] / lrow);
      }
    }
  }
}

// ------------------------------------------------ f32: CUDA-core kernel

constexpr int kFQ = 32;           // query rows of a block
constexpr int kFK = 32;           // keys of a tile
constexpr int kFP = kFK + 1;      // p tile pitch
constexpr int kFCols = 512 / 8;   // output columns a lane owns, at most
static_assert(kFQ == kFK, "load_tile_f32 copies kFQ rows of q, k and v");

size_t f32_smem_bytes(int D) {
  return (3ull * kFQ * (D + 1) + (size_t)kFQ * kFP) * 4;
}

// Rows [row0, row0 + 32) of one [N, D] f32 matrix into shared memory rows
// of D + 1 floats (the odd pitch spreads a column over the banks).
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int N, int D) {
  const int chunks = D / 4;
  for (int i = threadIdx.x; i < kFQ * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N)
      val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c));
    float* d = dst + r * (D + 1) + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// grid (ceil(N / 32), B), 256 threads: 8 lanes per query row; lane `sub`
// scores keys sub + 8 i and owns output columns sub + 8 j.
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int N,
                 int D, float scale) {
  extern __shared__ float fsm[];
  const int fp = D + 1;
  float* Qs = fsm;
  float* Ks = Qs + kFQ * fp;
  float* Vs = Ks + kFK * fp;
  float* Ps = Vs + kFK * fp;

  const int tid = threadIdx.x, row = tid >> 3, sub = tid & 7;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * kFQ;
  const int ncol = D / 8;
  load_tile_f32(Qs, q + base, q0, N, D);

  float m = kNegInit, l = 0.f;
  float acc[kFCols];
#pragma unroll
  for (int j = 0; j < kFCols; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kFK) {
    load_tile_f32(Ks, k + base, k0, N, D);
    load_tile_f32(Vs, v + base, k0, N, D);
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = Qs + row * fp;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(qd, Ks[(sub + 8 * i) * fp + d], s[i]);
    }
    const float alpha = online_softmax<4, 8>(s, sub, N - k0, scale, m, l);
#pragma unroll
    for (int i = 0; i < 4; ++i) Ps[row * kFP + sub + 8 * i] = s[i];
    __syncwarp();  // a row's 8 lanes share one warp

#pragma unroll
    for (int j = 0; j < kFCols; ++j)
      if (j < ncol) acc[j] *= alpha;
    for (int kk = 0; kk < kFK; ++kk) {
      const float p = Ps[row * kFP + kk];
      const float* vr = Vs + kk * fp + sub;
#pragma unroll
      for (int j = 0; j < kFCols; ++j)
        if (j < ncol) acc[j] = fmaf(p, vr[8 * j], acc[j]);
    }
    __syncthreads();
  }

  if (q0 + row < N) {
    float* orow = out + base + (size_t)(q0 + row) * D + sub;
#pragma unroll
    for (int j = 0; j < kFCols; ++j)
      if (j < ncol) orow[8 * j] = acc[j] / l;
  }
}

}  // namespace

// q, k, v, out: [B, N, D] contiguous, 16-byte aligned. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int svt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int N, int D, int dtype,
                                   float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || D < 32 || D > 512 || D % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    const size_t smem = bf16_smem_bytes(D);
    e = cudaFuncSetAttribute(flash_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + kBQ - 1) / kBQ, B);
    flash_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), N, D, scale);
  } else if (dtype == 0) {
    const size_t smem = f32_smem_bytes(D);
    e = cudaFuncSetAttribute(flash_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + kFQ - 1) / kFQ, B);
    flash_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), N, D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
