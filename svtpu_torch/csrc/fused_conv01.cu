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
// rate.
//
// bf16 (the main path): both convs on the tensor cores, fused_conv01_tc.
// - Work items are (image, 8x8 tile of conv1's output, all 64 channels).
//   A persistent grid of one 512-thread block per SM walks over them in
//   two halves of 8 warps, each half with its own conv0 tile and patch
//   buffers, so 16 warps hide each other's latency. The wrapper packs the
//   weights on the card before each launch (pack_w0, pack_w1 in
//   ops/conv_trunk_cuda.py); they are copied into shared memory once per
//   block, not once per tile: w1's row
//   co holds k = tap * 64 + ci, its 16-byte chunks XOR-swizzled by co % 8.
// - The 35x35x3 input patch of a half's next item is fetched with
//   cp.async (16-byte copies of whole row segments; copies outside the
//   image are zero-filled, which is conv0's padding) into the other of two
//   buffers while the current item computes.
// - conv0 is an implicit GEMM: M = the 17x17 = 289 conv0 pixels the tile
//   needs (19 m16 tiles, 13% halo recompute), N = 64, K = 27 taps x
//   channels padded to 32 with zero weights. A is gathered from the patch
//   by 16-bit loads at per-lane offsets, B (w0) by ldmatrix. Its sum is
//   rounded to bf16, the bf16 bias added and rounded, ReLU'd, and stored
//   as bf16 (37 KB) with conv1's zero padding; the 16-byte chunks of pixel
//   P are XOR-swizzled by (P / 2) % 8, so the stride-2 rows that conv1
//   reads hit 8 bank groups. On the CUDA cores conv0 alone would need
//   29 GFLOP / 67 TFLOP/s = 0.43 ms at B = 512.
// - conv1 is an implicit GEMM: M = 64 output pixels, N = 64, K = 9 taps x
//   64 channels = 576. ldmatrix takes one row address per lane, so the A
//   rows of tap (dy, dx), conv0 pixels at stride 2, are gathered straight
//   from the tile with no im2col copy. Each warp of a half owns 16 pixels
//   x 32 channels: per k-step one A and two B ldmatrix.x4 feed four
//   mma.sync m16n8k16 (bf16 in, f32 accumulate). Bias, ReLU and one
//   rounding to bf16 happen in registers before the store.
// - Shared memory: w1 73,728 + w0 5,120 (80-byte rows) + per half a conv0
//   tile of 36,992 and 2 patch buffers of 35 x 112 bf16 (7,840 each) =
//   184,192 bytes: one block (16 warps) per SM; 512 threads leave 128
//   registers a thread.
// - mma.sync, not wgmma, for conv1: its products are ~4x conv0's but
//   issue from a resident w1 and a swizzled tile, while conv0's 16-bit
//   gather and two-rounding epilogue are the likelier limit (PERF.md §7).
//
// f32 (parity checks only): the first, CUDA-core kernel, fused_conv01_kernel.
// One block per (image, 8x8 tile): the 35x35x3 input patch with its halo
// and the 17x17x64 conv0 tile (ReLU'd, conv1's zero padding included) in
// shared memory as f32, conv1 from there, every thread holding a 4-pixel x
// 8-channel tile of sums in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight consecutive floats (32-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
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

// ------------------------------------------------ bf16: tensor-core kernel

namespace tc {

constexpr int kThreads = 512;             // two halves of 8 warps
constexpr int kHalf = kThreads / 2;
constexpr int kRowElems = kImg * 3;          // 768 bf16 in an input row
constexpr int kPatchChunks = 14;             // 16-byte copies per patch row
constexpr int kPatchPitch = 8 * kPatchChunks;  // 112 bf16
// A patch row starts 16 elements before the tile's first input column
// (12 * ox0 - 9 in the row's elements) rounded to a 16-byte boundary: that
// column sits at element 7, and 14 chunks reach past its last one.
constexpr int kPatchShift = 7;
constexpr int kMidPix = kMidT * kMidT;        // 289 conv0 pixels a tile needs
constexpr int kMidMTiles = (kMidPix + 15) / 16;  // 19
constexpr int kK1 = 9 * kCh;                  // 576
constexpr int kItemsPerImg = kTilesPerDim * kTilesPerDim;  // 64
constexpr int kW1Elems = kCh * kK1;
constexpr int kW0Pitch = 40;                  // bf16: 80-byte rows, 8 bank groups
constexpr int kW0Elems = kCh * kW0Pitch;
constexpr int kMidElems = kMidPix * kCh;
constexpr int kPatchElems = kInT * kPatchPitch;
constexpr size_t kSmemBytes =
    2ull * (kW1Elems + kW0Elems + 2 * (kMidElems + 2 * kPatchElems));
static_assert(kSmemBytes == 184192, "shared memory sum of the header note");

// The input patch of work item `item` into `dst`, as cp.async copies by
// the 256 threads of one half of the block.
__device__ __forceinline__ void load_patch(uint16_t* dst, const uint16_t* x,
                                           int item) {
  const long long img = item / kItemsPerImg;
  const int tile = item % kItemsPerImg;
  const int iy0 = 4 * (tile / kTilesPerDim) * kTile - 3;
  const int e0 = 12 * (tile % kTilesPerDim) * kTile - 16;
  for (int p = threadIdx.x % kHalf; p < kInT * kPatchChunks; p += kHalf) {
    const int r = p / kPatchChunks, c = p % kPatchChunks;
    const int iy = iy0 + r, e = e0 + 8 * c;
    const bool valid = iy >= 0 && iy < kImg && e >= 0 && e < kRowElems;
    const uint16_t* src = valid ? x + (img * kImg + iy) * kRowElems + e : x;
    svt::cp_async16(dst + r * kPatchPitch + 8 * c, src, valid);
  }
}

// Barrier of half `hb` of the block (named barrier 1 + hb, 256 threads).
__device__ __forceinline__ void half_sync(int hb) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + hb) : "memory");
}

// Element offset of 16-byte chunk `chunk` of conv0 pixel `pix` in the tile.
__device__ __forceinline__ int mid_at(int pix, int chunk) {
  return pix * kCh + ((chunk ^ ((pix >> 1) & 7)) << 3);
}

// x [B,256,256,3] bf16; w0p [64][32] bf16 (pack_w0); b0 [64] bf16; w1p
// [64][576] bf16 (pack_w1); b1 [64] f32; out [B,64,64,64] bf16. `items` =
// 64 B. Half hb of the block (warps 8 hb .. 8 hb + 7) takes items
// 2 blockIdx.x + hb + 2 gridDim.x i with its own conv0 tile and patches.
// Its warp w: conv0 m-tiles w % 4 + 4 i, channels 32 (w / 4) ..; conv1
// output rows 2 (w % 4) and 2 (w % 4) + 1 of the tile, same channels.
__global__ void __launch_bounds__(kThreads, 1)
fused_conv01_tc(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w0p,
                const __nv_bfloat16* __restrict__ b0,
                const uint16_t* __restrict__ w1p, const float* __restrict__ b1,
                uint16_t* __restrict__ out, int items) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hb = warp >> 3, wm = warp & 3, nh = (warp >> 2) & 1;
  uint16_t* w1s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* w0s = w1s + kW1Elems;
  uint16_t* mid = w0s + kW0Elems + hb * (kMidElems + 2 * kPatchElems);
  uint16_t* patches = mid + kMidElems;

  int item = 2 * blockIdx.x + hb;
  const int stride = 2 * gridDim.x;
  for (int i = tid; i < kW1Elems / 8; i += kThreads)
    svt::cp_async16(w1s + 8 * i, w1p + 8 * i, true);
  for (int i = tid; i < kCh * 4; i += kThreads)
    svt::cp_async16(w0s + (i / 4) * kW0Pitch + 8 * (i % 4), w0p + 8 * i, true);
  if (item < items) load_patch(patches, x, item);
  svt::cp_async_commit();
  svt::cp_async_wait<0>();
  __syncthreads();  // w1 and the first patches landed

  // Patch offsets of this lane's A columns k = 16 ks + {2t, 2t+1, 2t+8,
  // 2t+9}, k = (ky * 3 + kx) * 3 + ci; k >= 27 meets a zero weight, so it
  // reads any finite element of the pixel's own window (offset 0).
  int koff[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * ks + 2 * t + (j & 1) + 8 * (j >> 1);
      koff[ks][j] = k < 27 ? (k / 9) * kPatchPitch + ((k / 3) % 3) * 3 + k % 3 : 0;
    }
  // conv1's ldmatrix rows: A row i = (lane & 7) + 8 ((lane >> 3) & 1) is
  // output pixel (2 wm + i / 8, i % 8), k-half lane >> 4; B row (output
  // channel) 32 nh + (lane & 7) + 8 (lane >> 4) [+ 16 q], k-half
  // (lane >> 3) & 1.
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_pix0 = 2 * (2 * wm + (arow >> 3)) * kMidT + 2 * (arow & 7);
  const int a_khalf = lane >> 4;
  const int b_co = 32 * nh + (lane & 7) + 8 * (lane >> 4);
  const int b_khalf = (lane >> 3) & 1;
  // This thread's output channels (C columns) 32 nh + 8 nt + 2 t, + 1,
  // and conv0's bias for them.
  const int co_c = 32 * nh + 2 * t;
  float bias0[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias0[nt][e] = __bfloat162float(b0[co_c + 8 * nt + e]);

  for (int it = 0; item < items; ++it, item += stride) {
    const uint16_t* patch = patches + (it & 1) * kPatchElems;
    const int next = item + stride;
    svt::cp_async_wait<0>();
    half_sync(hb);  // this patch landed; the last conv1 is done
    if (next < items) load_patch(patches + ((it + 1) & 1) * kPatchElems, x, next);
    svt::cp_async_commit();

    const long long img = item / kItemsPerImg;
    const int tile = item % kItemsPerImg;
    const int oy0 = (tile / kTilesPerDim) * kTile, ox0 = (tile % kTilesPerDim) * kTile;

    // 1. conv0 on the tensor cores into the bf16 tile.
    for (int mt = wm; mt < kMidMTiles; mt += 4) {
      int pix[2], base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pix[h] = 16 * mt + g + 8 * h;
        const int p = pix[h] < kMidPix ? pix[h] : kMidPix - 1;
        base[h] = 2 * (p / kMidT) * kPatchPitch + kPatchShift + 6 * (p % kMidT);
      }
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t wb[2][4];  // w0's B fragments, n-tiles 2 q and 2 q + 1
#pragma unroll
        for (int q = 0; q < 2; ++q)
          svt::ldmatrix_x4(wb[q], w0s + (b_co + 16 * q) * kW0Pitch + 16 * ks + 8 * b_khalf);
        const uint32_t a[4] = {
            svt::pack_raw(patch[base[0] + koff[ks][0]], patch[base[0] + koff[ks][1]]),
            svt::pack_raw(patch[base[1] + koff[ks][0]], patch[base[1] + koff[ks][1]]),
            svt::pack_raw(patch[base[0] + koff[ks][2]], patch[base[0] + koff[ks][3]]),
            svt::pack_raw(patch[base[1] + koff[ks][2]], patch[base[1] + koff[ks][3]])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) svt::mma_bf16_16816(acc[nt], a, wb[nt >> 1] + 2 * (nt & 1));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pix[h] >= kMidPix) continue;
        const int R = 2 * oy0 - 1 + pix[h] / kMidT, C = 2 * ox0 - 1 + pix[h] % kMidT;
        const bool inside = R >= 0 && R < kMid && C >= 0 && C < kMid;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = inside ? fmaxf(round_to(round_to(acc[nt][2 * h + e], __nv_bfloat16()) +
                                               bias0[nt][e],
                                           __nv_bfloat16()),
                                  0.f)
                          : 0.f;  // conv1's zero padding
          *reinterpret_cast<uint32_t*>(mid + mid_at(pix[h], 4 * nh + nt) + 2 * t) =
              svt::pack_bf16(v[0], v[1]);
        }
      }
    }
    half_sync(hb);

    // 2. conv1 on the tensor cores: 9 taps x 4 k-steps of 16 channels.
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 3  // full unrolling spills at the 128 registers of 512 threads
    for (int tap = 0; tap < 9; ++tap) {
      const int pix = a_pix0 + (tap / 3) * kMidT + tap % 3;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4], b[2][4];
        svt::ldmatrix_x4(a, mid + mid_at(pix, 2 * s + a_khalf));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int co = b_co + 16 * q;
          const int chunk = 8 * tap + 2 * s + b_khalf;
          svt::ldmatrix_x4(b[q], w1s + co * kK1 + ((chunk ^ (co & 7)) << 3));
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          svt::mma_bf16_16816(acc[2 * q], a, b[q]);
          svt::mma_bf16_16816(acc[2 * q + 1], a, b[q] + 2);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oy = oy0 + 2 * wm + h, ox = ox0 + g;
      uint16_t* orow = out + ((img * kOut + oy) * kOut + ox) * kCh + 32 * nh + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<uint32_t*>(orow + 8 * nt) =
            svt::pack_bf16(fmaxf(acc[nt][2 * h] + b1[co_c + 8 * nt], 0.f),
                           fmaxf(acc[nt][2 * h + 1] + b1[co_c + 8 * nt + 1], 0.f));
    }
  }
  svt::cp_async_wait<0>();
}

int launch(const void* x, const void* w0p, const void* b0, const void* w1p,
           const float* b1, void* out, long long batch, cudaStream_t stream) {
  if (batch * kItemsPerImg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_conv01_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_conv01_tc, kThreads,
                                                         kSmemBytes)) != cudaSuccess)
    return (int)e;
  const int items = (int)(batch * kItemsPerImg);
  const int pairs = (items + 1) / 2;
  const int grid = pairs < sms * per_sm ? pairs : sms * per_sm;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  fused_conv01_tc<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w0p),
      static_cast<const __nv_bfloat16*>(b0), static_cast<const uint16_t*>(w1p), b1,
      static_cast<uint16_t*>(out), items);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// dtype 0 = float32: w0, w1 HWIO, the CUDA-core kernel. dtype 1 = bfloat16:
// w0, w1 as pack_w0 and pack_w1 lay them out, the tensor-core kernel.
// Returns cudaGetLastError() of the launch.
extern "C" int svt_fused_conv01(const void* x, const void* w0, const void* b0,
                                const void* w1, const void* b1, void* out,
                                long long batch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  switch (dtype) {
    case 0: return launch<float>(x, w0, b0, w1, b1f, out, batch, s);
    case 1: return tc::launch(x, w0, b0, w1, b1f, out, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
