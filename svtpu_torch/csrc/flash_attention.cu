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
// bf16 at other D (multiples of 32 up to 512), flash_bf16_kernel, the first
// version: the output width split across the 8 warps of one block, each
// warp holding all 64 rows x D/8 columns; the 64 x 64 score tile computed
// once per block over the whole D (each warp a 16 x 32 piece) and shared as
// f32 and as bf16 p through shared memory; tiles loaded synchronously.
//
// f32 inputs take a third, plain kernel on the CUDA cores (32 x 32 tiles,
// f32 FMAs, p kept in f32 as the TPU kernel's p.astype(float32) does), used
// by the f32 parity checks.
//
// ops/attention.py::kernel_for chooses the kernel from (dtype, D) and
// passes it to the launcher: bf16 and D = 512 -> flash_d512_kernel; other
// bf16 -> flash_bf16_kernel; f32 -> flash_f32_kernel.

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
// 1 = flash_bf16_kernel, 2 = flash_d512_kernel (bfloat16, D = 512 only).
// Returns cudaGetLastError() of the launch.
extern "C" int svt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int N, int D, int kernel,
                                   float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || D < 32 || D > 512 || D % 32 ||
      (kernel == 2 && D != d512::kD))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (kernel == 2) {
    return d512::launch(q, k, v, out, B, N, scale, s);
  } else if (kernel == 1) {
    const size_t smem = bf16_smem_bytes(D);
    e = cudaFuncSetAttribute(flash_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + kBQ - 1) / kBQ, B);
    flash_bf16_kernel<<<grid, kThreads, smem, s>>>(
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
