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
// 128 KB, too much for one warp's registers and most of a block's shared
// memory, and splitting the width across blocks would recompute q k^T once
// per split, (2 + 2 s) B N^2 D FLOPs, 2.5x at s = 4.
//
// bf16 at D = 512 (the SD model's only width), flash_d512_kernel, on wgmma:
// - One block of two warpgroups per 64 query rows. Warpgroup h owns all 64
//   rows and one half of the output width, columns 256 h .. 256 h + 255:
//   its accumulator is 64 x 256 f32, 128 registers a thread.
// - Scores by split-K over D. Each warpgroup computes the 64 x 64 scores
//   of a key tile over its half of D (16 wgmma m64n64k16, q and k read
//   from shared memory through descriptors) and adds the other's partial
//   through shared memory: 16 KB written and 16 KB read per warpgroup and
//   key tile, one block barrier, against 192 KB of wgmma operand reads and
//   128 KB of tile fills. Both then hold the same scores bit for bit (f32
//   addition commutes), so the work stays exactly 4 B N^2 D FLOPs. A pair
//   of named barriers (bar.arrive / bar.sync) keeps a warpgroup from
//   writing its next partial before the other has read the last one.
// - Softmax in registers: each lane holds 32 scores of 2 rows; row maxima
//   and sums are 2 shuffles. p is rounded to bf16 in registers, where the
//   wgmma accumulator layout is the register A operand of p v (wgmma
//   m64n256k16, v [keys, D] as an MN-major B: the transpose bit), so no
//   score passes through shared memory as f32 or bf16. The accumulator's
//   rescale is skipped when no row maximum of the warp moved (a factor of
//   exactly 1).
// - Asynchronous products and loads. Step j starts q k(j)^T and p v(j - 1)
//   and runs the exchange and softmax of tile j while p v(j - 1) is on the
//   tensor cores. A warpgroup reads only its own halves of q, k and v, so
//   one of its threads fetches them with TMA (64 x 64 boxes, 128-byte
//   swizzle, zeros past N) onto its own mbarriers: v(j) as soon as its
//   p v(j - 1) is done, k(j + 1) as soon as both halves of q k(j)^T are.
//   A 64-key tile is 64 KB, so the ring holds one k and one v stage; a
//   two-stage ring of 32-key tiles with cp.async measured slower (PERF.md).
// - Shared memory: q, k, v 3 x 65,536 + the exchange 2 x 16,384 + 4
//   mbarriers + 1,024 of alignment = 230,432 bytes of the 232,448 a block
//   may have: one block per SM.
// - Wave tail: the grid is ceil(N / 64) x B blocks, 220 x 8 = 1,760 at the
//   SD shape: 13.33 waves on 132 SMs, so the last wave is a third full and
//   costs ~5% (14 against 13.33 waves of work). Not addressed here.
// - The TMA maps come from cuTensorMapEncodeTiled, found through
//   cudaGetDriverEntryPoint (no link against libcuda).
//
// bf16 at D = 64 (V-JEPA 2's heads: [clips x 16, 8,192, 64] on the clip
// path), d64::flash_bf16_kernel, warp-specialised on wgmma and TMA:
// - Bound by operations: at [32, 8192, 64] the two products are 549.8 GFLOP
//   against 134 MB of q, k, v and out, 0.556 ms at the bf16 tensor-core
//   rate and 0.040 ms of bytes.
// - The exponentials matter at this width. A score costs 4 D = 256 FLOPs
//   on the tensor cores (1/16 of an SM's clock at 989 TFLOP/s) and one ex2
//   on the MUFU units, which do 16 an SM and clock: also 1/16. Run after
//   the products, the softmax alone would hold the kernel under half of
//   the peak, so the design keeps it beside them.
// - One block per 192 query rows of one (clip, head) slice, four
//   warpgroups. Warpgroup 0 is the producer: its registers lowered to 24
//   (setmaxnreg), one thread keeps TMA loads in flight: q once (192 x 64),
//   then k and v as 128-key x 64 tiles (16 KB each, 128-byte swizzle, zeros
//   past N from the 3-D [B, N, D] maps) through a ring of 4 stages on full
//   and empty mbarriers. Warpgroups 1-3 are consumers of 64 rows each, at
//   160 registers.
// - S = q k^T with 4 wgmma m64n128k16, q and k from shared memory. The
//   softmax runs in registers in the accumulator's layout (each lane holds
//   64 scores of 2 rows; row maxima take 2 shuffles; l is summed a lane and
//   reduced once at the end). p is rounded to bf16 in registers and is the
//   register A operand of p v (8 wgmma m64n64k16, v MN-major: the transpose
//   bit). No score passes through shared memory.
// - The softmax hides under the tensor cores two ways: within a
//   warpgroup, step j issues q k(j)^T and p v(j - 1) and runs the softmax
//   of tile j while p v(j - 1) runs; across warpgroups, the three
//   consumers issue their products in turn (named barriers, a ring), so
//   one's exponentials run while the others' products are on the tensor
//   cores (faster than free-running consumers, and three consumers faster
//   than two: PERF.md). The accumulator's rescale is skipped when no row
//   maximum of the warp moved.
// - The exponential is ex2.approx.ftz of s * (scale log2 e) - m log2 e in
//   one FFMA: the scaled score's and the argument's rounding cost a few f32
//   ulps of p, far below its bf16 rounding; m is the max of the scaled
//   scores (max(s) * scale, equal to max(s * scale) since scale > 0).
// - Shared memory: q 24,576 + k and v 4 x 2 x 16,384 + 17 mbarriers +
//   1,024 of alignment = 156,808 bytes: one block per SM.
// - Grid ceil(N / 192) x B: 43 x 32 = 1,376 blocks at [32, 8192, 64],
//   10.4 waves on 132 SMs (the last row block of a slice two-thirds full).
//   No atomics and no split over keys: deterministic, as a graph replay
//   must be bit for bit.
//
// bf16 at other D (multiples of 32 up to 512 other than 64 and 512: no
// model of the repo runs one; chip_smoke.py checks 96), flash_mma_kernel,
// the first version, on mma.sync: the output width split across the 8
// warps of one block, each warp holding all 64 rows x D/8 columns; the
// 64 x 64 score tile computed once per block over the whole D (each warp a
// 16 x 32 piece) and shared as f32 and as bf16 p through shared memory;
// tiles loaded synchronously.
//
// f32 inputs take a third, plain kernel on the CUDA cores (32 x 32 tiles,
// f32 FMAs, p kept in f32 as the TPU kernel's p.astype(float32) does), used
// by the f32 parity checks.
//
// ops/attention.py::kernel_for chooses the kernel from (dtype, D) and
// passes it to the launcher: bf16 and D = 512 -> flash_d512_kernel; bf16
// and D = 64 -> d64::flash_bf16_kernel; other bf16 -> flash_mma_kernel;
// f32 -> flash_f32_kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// ---------------------------------------- bf16, other D: mma.sync kernel

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
flash_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
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
        svt::mma_bf16_16816(sacc[j], a, b);
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
          b[nt][0] = svt::pack_raw(vb[0], vb[pitch]);
          b[nt][1] = svt::pack_raw(vb[8 * pitch], vb[9 * pitch]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint16_t* pa = Ps + (16 * mt + g) * kPP + kk + 2 * t;
        const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * kPP), ld32(pa + 8),
                               ld32(pa + 8 * kPP + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          if (nt < ntiles) svt::mma_bf16_16816(acc[mt][nt], a, b[nt]);
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

// ------------------------------------------- bf16, D = 512: the main kernel

namespace d512 {

constexpr int kD = 512;
constexpr int kRows = 64;               // query rows of a block, keys of a tile
constexpr int kTile = kRows * kD;       // bf16 in one tile
constexpr int kPanel = kRows * 64;      // bf16 in one 64-column panel (8 KB)
constexpr int kExFloats = 32 * 128;     // one warpgroup's partial scores
constexpr uint32_t kHalfBytes = kTile;  // one warpgroup's half of a tile
// q, k, v tiles, the exchange, 4 mbarriers, and slack to align the tiles
// to 1,024 bytes.
constexpr size_t kSmemBytes =
    3ull * kTile * 2 + 2ull * kExFloats * 4 + 4 * 8 + 1024;
static_assert(kSmemBytes == 230432, "shared memory sum of the header note");

// Rows [row0, row0 + 64) x columns [256 wg, 256 wg + 256) of one
// [B, N, 512] tensor (its TMA map, 64 x 64 boxes, 128-byte swizzle) into a
// tile, by one thread of warpgroup wg: four 8 KB panels completing on
// `bar`, which the caller has told to expect them. TMA writes zeros for
// rows past N.
__device__ __forceinline__ void load_half(uint16_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int batch,
                                          int wg) {
#pragma unroll
  for (int p = 4 * wg; p < 4 * wg + 4; ++p)
    svt::tma_load_3d(dst + p * kPanel, map, bar, 64 * p, row0, batch);
}

// Barrier of warpgroup wg's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Warpgroup wg's partial scores are read (bar.arrive by the partner) before
// wg writes the next ones (bar.sync): named barrier 3 + wg over 256 threads.
__device__ __forceinline__ void exchange_free_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void exchange_free_signal(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + wg) : "memory");
}

// grid (ceil(N / 64), B), 256 threads = 2 warpgroups; see the header note.
__global__ void __launch_bounds__(kThreads, 1)
flash_d512_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  uint16_t* __restrict__ out, int N, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_d512[];
  unsigned char* base_ptr =
      smem_d512 + ((1024 - (svt::smem_u32(smem_d512) & 1023)) & 1023);
  uint16_t* Qs = reinterpret_cast<uint16_t*>(base_ptr);
  uint16_t* Ks = Qs + kTile;
  uint16_t* Vs = Ks + kTile;
  float* ex = reinterpret_cast<float*>(Vs + kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ex + 2 * kExFloats);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;  // half of D; 16-row slice
  const int batch = blockIdx.y;
  const size_t base = (size_t)batch * N * kD;
  const int q0 = blockIdx.x * kRows;
  // Per warpgroup: q with k(0), then k(j), and v(j); one thread loads.
  uint64_t* bar_k = bars + wg;
  uint64_t* bar_v = bars + 2 + wg;
  const bool loader = (tid & 127) == 0;
  if (tid < 4) svt::mbar_init(bars + tid, 1);
  svt::mbar_init_fence();
  __syncthreads();
  if (loader) {
    svt::mbar_expect_tx(bar_k, 2 * kHalfBytes);
    load_half(Qs, &tq, bar_k, q0, batch, wg);
    load_half(Ks, &tk, bar_k, 0, batch, wg);
  }

  float* ex_mine = ex + wg * kExFloats + (tid & 127);
  const float* ex_theirs = ex + (wg ^ 1) * kExFloats + (tid & 127);
  // Descriptors: q and k K-major (8-row groups 1,024 bytes apart), this
  // warpgroup's panels 4 wg .. 4 wg + 3; v MN-major, its 256 columns as 4
  // panels 8,192 bytes apart.
  const uint16_t* q_half = Qs + 4 * wg * kPanel;
  const uint16_t* k_half = Ks + 4 * wg * kPanel;
  const uint16_t* v_half = Vs + 4 * wg * kPanel;

  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t pa[4][4];  // p(j - 1) in bf16, the A operand of p v(j - 1)
  float s[32];        // scores of tile j, then its unrounded p

  // Step j computes q k(j)^T and its softmax while p v(j - 1) runs on the
  // tensor cores. A warpgroup reads only its own halves of q, k and v, so
  // it fetches them itself: v(j) as soon as its p v(j - 1) is done (during
  // the next q k^T), k(j + 1) as soon as the exchange shows both halves of
  // q k(j)^T done (during the softmax and p v(j - 1)). Step `tiles` only
  // finishes p v(tiles - 1).
  const int tiles = (N + kRows - 1) / kRows;
  for (int j = 0; j <= tiles; ++j) {
    const int k0 = j * kRows;
    const bool has_s = j < tiles, has_pv = j > 0;
    if (has_s) svt::mbar_wait(bar_k, j & 1);  // k(j) landed (and q, at j = 0)

    // 1. This warpgroup's half of q k(j)^T: 64 rows x 64 keys over 256 of D.
    if (has_s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      svt::wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          svt::wgmma_m64n64k16_ss(
              s, svt::desc_sw128(q_half + p * kPanel + 16 * ks, 16, 1024),
              svt::desc_sw128(k_half + p * kPanel + 16 * ks, 16, 1024));
      svt::wgmma_commit();
    }

    // 2. acc += p v(j - 1): 64 rows x this warpgroup's 256 columns.
    if (has_pv) {
      svt::mbar_wait(bar_v, (j - 1) & 1);  // v(j - 1) landed
      svt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        svt::wgmma_m64n256k16_rs_tb(
            acc, pa[kk], svt::desc_sw128(v_half + 16 * kk * 64, 2 * kPanel, 1024));
      svt::wgmma_commit();
    }

    // 3. Whole scores of tile j and their online softmax (rows g and g + 8
    //    of this warp's 16), while p v(j - 1) runs.
    float alpha[2] = {1.f, 1.f};
    if (has_s) {
      if (has_pv)
        svt::wgmma_wait<1>();
      else
        svt::wgmma_wait<0>();
      svt::fence_regs<32>(s);
      if (j > 0) exchange_free_wait(wg);  // the partner read the last ones
#pragma unroll
      for (int i = 0; i < 32; ++i) ex_mine[128 * i] = s[i];
      __syncthreads();  // partials visible; k(j) is no longer read
      if (loader && j + 1 < tiles) {
        svt::mbar_expect_tx(bar_k, kHalfBytes);
        load_half(Ks, &tk, bar_k, k0 + kRows, batch, wg);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += ex_theirs[128 * i];
      if (j + 1 < tiles) exchange_free_signal(wg ^ 1);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = key < N ? __fmul_rn(s[i], scale) : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = expf(s[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
    }


    // 4. p v(j - 1) done: fetch v(j); rescale for tile j and round its p.
    svt::wgmma_wait<0>();
    svt::fence_regs<128>(acc);
    wg_sync(wg);  // every warp of the group is past p v(j - 1)
    if (loader && has_s) {
      svt::mbar_expect_tx(bar_v, kHalfBytes);
      load_half(Vs, &tv, bar_v, k0, batch, wg);
    }
    if (has_s) {
      // A factor of exactly 1 (no row's maximum moved) changes nothing.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pa[kk][u] = svt::pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
    }
  }

  // out = acc / l, rounded once to bf16; rows past N are not stored.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * wr + g + 8 * h;
    if (row >= N) continue;
    uint16_t* orow = out + base + (size_t)row * kD + 256 * wg + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          svt::pack_bf16(acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
  }
}

// cuTensorMapEncodeTiled, from libcuda through the runtime's entry point
// query (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of one [B, N, 512] bf16 tensor: 64-row x 64-column boxes,
// 128-byte swizzle, zeros outside.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)N * kD * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int N,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = make_map(&tq, q, B, N)) != cudaSuccess ||
      (e = make_map(&tk, k, B, N)) != cudaSuccess ||
      (e = make_map(&tv, v, B, N)) != cudaSuccess)
    return (int)e;
  e = cudaFuncSetAttribute(flash_d512_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kRows - 1) / kRows, B);
  flash_d512_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), N, scale);
  return (int)cudaGetLastError();
}

}  // namespace d512

// -------------------------------------------- bf16, D = 64: the clip kernel

namespace d64 {

constexpr int kD = 64;                      // a key's row: one 128-byte row
constexpr int kConsumers = 3;               // consumer warpgroups of a block
constexpr int kRows = 64 * kConsumers;      // query rows of a block
constexpr int kKeys = 128;                  // keys of a tile
constexpr int kStages = 4;                  // k and v tiles in flight
constexpr int kThreadsWS = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "the register file of one SM");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1,024-aligned base: q, the k ring, the v
// ring, then the mbarriers (q; k and v full; k and v empty).
constexpr int kQBytes = kRows * kD * 2;
constexpr int kTileBytes = kKeys * kD * 2;
constexpr int kSmemK = kQBytes;
constexpr int kSmemV = kSmemK + kStages * kTileBytes;
constexpr int kSmemBars = kSmemV + kStages * kTileBytes;
constexpr int kSmemBytes = kSmemBars + (1 + 4 * kStages) * 8 + 1024;
static_assert(kSmemBytes == 156808, "shared memory sum of the header note");

// Arrival of one warp (its lane 0) on an empty barrier: the warp no longer
// reads that stage.
__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) svt::mbar_arrive(bar);
}

// S = q k^T of one warpgroup: 64 rows x 128 keys over D = 64, four wgmma
// m64n128k16 on the 128-byte-swizzled q rows and k tile.
__device__ __forceinline__ void issue_scores(float* s, const uint16_t* q,
                                             const uint16_t* k) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    svt::wgmma_m64n128k16_ss(s, svt::desc_sw128(q + 16 * ks, 16, 1024),
                             svt::desc_sw128(k + 16 * ks, 16, 1024), ks);
}

// acc += p v: p (64 x 128 keys, bf16 in registers, 8 A fragments) times the
// v tile (128 keys x 64, MN-major), eight wgmma m64n64k16.
__device__ __forceinline__ void issue_pv(float* acc, uint32_t (*pa)[4],
                                         const uint16_t* v) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    svt::wgmma_m64n64k16_rs_tb(acc, pa[kk],
                               svt::desc_sw128(v + 16 * kk * kD, 8192, 1024));
}

// Online softmax of one tile in the accumulator's layout: s[4 j + e] is row
// g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2. Masks keys at or past N,
// updates the running max m (scaled scores) and this lane's share of l,
// leaves the unrounded p in s and the rescale factors in alpha.
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* alpha, int k0, int N,
                                             int t, float scale,
                                             float scale_log2) {
  if (k0 + kKeys > N) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= N) s[i] = -INFINITY;
  }
  // Row maxima of the raw scores, two partial maxima a row; scale > 0, so
  // max(s) * scale rounds to max(s * scale) exactly.
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[i & 3] = fmaxf(mx[i & 3], s[i]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[2 * r], mx[2 * r + 1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * scale);
    alpha[r] = m_new == m[r] ? 1.f : svt::ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    mb[r] = m_new * kLog2e;
  }
  // p = exp(s * scale - m) as 2^(s * scale log2 e - m log2 e).
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = svt::ex2(fmaf(s[i], scale_log2, -mb[(i >> 1) & 1]));
    sum[i & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + (sum[2 * r] + sum[2 * r + 1]);
}

// p rounded to bf16 in pairs: the accumulator of keys 16 kk .. 16 kk + 15
// is the A fragment of the kk-th k-step of p v as it stands.
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      pa[kk][u] = svt::pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
}

// Keep p's registers, which p v reads asynchronously, alive up to here.
__device__ __forceinline__ void hold_p(uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(pa[kk][u])::"memory");
}

// The consumers issue their products in turn, c = 0, 1, 2, 0, ...: named
// barrier 1 + c over two warpgroups, on which c waits and its predecessor
// in the ring arrives once it has issued its own.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (c + 1) % kConsumers)
               : "memory");
}

// grid (ceil(N / kRows), B), kThreadsWS threads: warpgroup 0 loads, the
// others compute 64 query rows each; see the header note.
__global__ void __launch_bounds__(kThreadsWS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  uint16_t* __restrict__ out, int N, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_d64[];
  unsigned char* sm =
      smem_d64 + ((1024 - (svt::smem_u32(smem_d64) & 1023)) & 1023);
  uint16_t* Qs = reinterpret_cast<uint16_t*>(sm);
  uint16_t* Ks = reinterpret_cast<uint16_t*>(sm + kSmemK);
  uint16_t* Vs = reinterpret_cast<uint16_t*>(sm + kSmemV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + kSmemBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int batch = blockIdx.y, q0 = blockIdx.x * kRows;
  const int tiles = (N + kKeys - 1) / kKeys;
  if (tid == 0) {
    svt::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      svt::mbar_init(k_full + st, 1);
      svt::mbar_init(v_full + st, 1);
      svt::mbar_init(k_empty + st, 4 * kConsumers);
      svt::mbar_init(v_empty + st, 4 * kConsumers);
    }
    svt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full. Tile j waits for the
    // consumers to release tile j - kStages from its stage.
    svt::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      svt::mbar_expect_tx(q_full, kQBytes);
      svt::tma_load_3d(Qs, &tq, q_full, 0, q0, batch);
      for (int j = 0; j < tiles; ++j) {
        const int st = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        if (j >= kStages) svt::mbar_wait(k_empty + st, parity);
        svt::mbar_expect_tx(k_full + st, kTileBytes);
        svt::tma_load_3d(Ks + st * kKeys * kD, &tk, k_full + st, 0, j * kKeys,
                         batch);
        if (j >= kStages) svt::mbar_wait(v_empty + st, parity);
        svt::mbar_expect_tx(v_full + st, kTileBytes);
        svt::tma_load_3d(Vs + st * kKeys * kD, &tv, v_full + st, 0, j * kKeys,
                         batch);
      }
    }
  } else {
    // Consumer c: query rows q0 + 64 c .. q0 + 64 c + 63. Step j issues
    // q k(j)^T and p v(j - 1) in c's turn, then runs the softmax of tile j
    // while p v(j - 1) and the other consumers' products are on the tensor
    // cores.
    svt::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint16_t* q_mine = Qs + c * 64 * kD;
    const float scale_log2 = scale * kLog2e;
    float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, alpha[2];
    float s[64], acc[32];
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    if (c == kConsumers - 1) turn_pass(c);  // consumer 0 goes first
    svt::mbar_wait(q_full, 0);
    svt::mbar_wait(k_full, 0);
    turn_wait(c);
    svt::wgmma_fence();
    issue_scores(s, q_mine, Ks);
    svt::wgmma_commit();
    turn_pass(c);
    svt::wgmma_wait<0>();
    svt::fence_regs<64>(s);
    release(k_empty);
    softmax_tile(s, m, l, alpha, 0, N, t, scale, scale_log2);
    pack_p(pa, s);

    for (int j = 1; j < tiles; ++j) {
      const int st = j % kStages, pv = (j - 1) % kStages;
      svt::mbar_wait(k_full + st, (j / kStages) & 1);
      turn_wait(c);
      svt::wgmma_fence();
      issue_scores(s, q_mine, Ks + st * kKeys * kD);
      svt::wgmma_commit();
      svt::mbar_wait(v_full + pv, ((j - 1) / kStages) & 1);
      svt::wgmma_fence();
      issue_pv(acc, pa, Vs + pv * kKeys * kD);
      svt::wgmma_commit();
      turn_pass(c);

      svt::wgmma_wait<1>();  // q k(j)^T done; p v(j - 1) still running
      svt::fence_regs<64>(s);
      release(k_empty + st);
      softmax_tile(s, m, l, alpha, j * kKeys, N, t, scale, scale_log2);

      svt::wgmma_wait<0>();  // p v(j - 1) done
      svt::fence_regs<32>(acc);
      hold_p(pa);
      release(v_empty + pv);
      // A factor of exactly 1 (no row's maximum moved) changes nothing.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      pack_p(pa, s);
    }

    const int pv = (tiles - 1) % kStages;
    svt::mbar_wait(v_full + pv, ((tiles - 1) / kStages) & 1);
    turn_wait(c);
    svt::wgmma_fence();
    issue_pv(acc, pa, Vs + pv * kKeys * kD);
    svt::wgmma_commit();
    if (c != kConsumers - 1) turn_pass(c);  // the last turn has no taker
    svt::wgmma_wait<0>();
    svt::fence_regs<32>(acc);
    hold_p(pa);

    // out = acc / l, rounded once to bf16; rows past N are not stored.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lr = l[h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = q0 + 64 * c + 16 * warp + g + 8 * h;
      if (row >= N) continue;
      uint16_t* orow = out + ((size_t)batch * N + row) * kD + 2 * t;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            svt::pack_bf16(acc[4 * j + 2 * h] / lr, acc[4 * j + 2 * h + 1] / lr);
    }
  }
}

// The TMA map of one [B, N, D] bf16 tensor: boxes of `rows` x D, 128-byte
// swizzle, zeros outside.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int N, int D,
                     int rows) {
  const d512::EncodeTiled encode = d512::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int N,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = make_map(&tq, q, B, N, kD, kRows)) != cudaSuccess ||
      (e = make_map(&tk, k, B, N, kD, kKeys)) != cudaSuccess ||
      (e = make_map(&tv, v, B, N, kD, kKeys)) != cudaSuccess)
    return (int)e;
  e = cudaFuncSetAttribute(flash_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kRows - 1) / kRows, B);
  flash_bf16_kernel<<<grid, kThreadsWS, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), N, scale);
  return (int)cudaGetLastError();
}

}  // namespace d64

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

// q, k, v, out: [B, N, D] contiguous, 16-byte aligned. kernel, as
// ops/attention.py::kernel_for chooses it: 0 = flash_f32_kernel (float32),
// 1 = flash_mma_kernel, 2 = flash_d512_kernel (bfloat16, D = 512 only),
// 3 = d64::flash_bf16_kernel (bfloat16, D = 64 only). Returns
// cudaGetLastError() of the launch.
extern "C" int svt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int N, int D, int kernel,
                                   float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || D < 32 || D > 512 || D % 32 ||
      (kernel == 2 && D != d512::kD) || (kernel == 3 && D != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (kernel == 3) {
    return d64::launch(q, k, v, out, B, N, scale, s);
  } else if (kernel == 2) {
    return d512::launch(q, k, v, out, B, N, scale, s);
  } else if (kernel == 1) {
    const size_t smem = bf16_smem_bytes(D);
    e = cudaFuncSetAttribute(flash_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + kBQ - 1) / kBQ, B);
    flash_mma_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), N, D, scale);
  } else if (kernel == 0) {
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
