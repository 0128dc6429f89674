// Windowed, query-pooled and global attention at head width D = 72 for
// Hopper (sm_90a): the attention of SAM 2.1's Hiera image encoder
// (models/sam2.py), softmax(q k^T / sqrt(72)) v inside each window.
//
// Rounding is that of flash_attention.cu: q k^T from bf16 operands
// accumulated in f32 and scaled in f32, an online softmax in f32 over key
// tiles whose running max starts at -1e30 and whose denominator sums the
// unrounded p, p rounded to bf16 before the p v product (f32
// accumulation), and the output acc / l cast once to bf16.
//
// The work, per 1024x1024 frame, as (windows x heads, Nq, Nk) at D = 72:
// (2048, 64, 64), (4096, 16, 64), (4096, 16, 16), (8192, 4, 16),
// (128, 256, 256), (256, 64, 256), (256, 64, 64) windowed or query-pooled
// (Nq = Nk / 4 at the first block of stages 2-4), and (8, 4096, 4096)
// global at three blocks of stage 3.
//
// Bound. The windowed shapes are bound by bytes: a token's q, k, v and
// output are read or written once (2 x 72 bytes each) for 4 Nk x 72
// operations, 32 to 128 operations a byte against the card's 295 (989
// TFLOP/s over 3.35 TB/s); ~1.4 GB a frame, ~0.42 ms. The global shape is
// bound by operations: 38.7 GFLOP a block and frame against 19 MB.
//
// Design (one device function, two kernels named for their traces:
// window_attn_kernel for windows, flash_d72_kernel for global attention):
// - A window's queries and keys are addressed where the model left them:
//   token (y, x) of a frame's [H, W] grid, head h, at ptr + b sb + (y W +
//   x) st + 72 h. The model's qkv product [B, H, W, 3 C] is read in place
//   (q, k and v are its three column blocks, token stride 3 C), and the
//   output is written in the [B, Hq, Wq, C] grid the projection reads: no
//   partition or unpartition copies. The flat [B, N, 72] layout of
//   ops/attention.py::flash_attention is the case of one window a row.
// - Items are (frame, window, head) triples, the head innermost; their
//   queries are laid end to end, and a block of 4 warps takes 64
//   consecutive query rows, 16 a warp. Where Nq < 64 a block holds
//   several items (4 windows' heads at Nq = 16, 16 at Nq = 4): a row
//   attends only its own item's keys, a block-diagonal mask held as one
//   key range a row, [item Nk, item Nk + Nk). Where Nq >= 64 a block lies
//   inside one item and its 4 warps share every key tile. A 4- or
//   16-token window never gets a tile of its own.
// - Keys stream through shared memory in 64-key tiles, double-buffered
//   with cp.async: the block's key range is the union of its items'; a
//   warp computes only the tiles that meet its own rows' range (at Nk / Nq
//   = 4 each warp computes one of the block's 4 tiles).
// - Products on mma.sync: the windows are too small for wgmma's 64-row
//   warpgroup tiles, and the bytes bound them. q k^T as 4 m16n8k16 steps
//   and one m16n8k8 step over D = 72 (no padding); p v over 9 n8 tiles of
//   D. Fragments from shared memory by ldmatrix (v transposed); rows of 144
//   bytes fall on distinct banks for every 8-row ldmatrix. The scores'
//   accumulator is the A operand of p v as it stands. The exponential is
//   ex2.approx of s (scale log2 e) - m log2 e.
// - Index arithmetic by multiply-shift division (FastDiv), set on the
//   host; one row address a thread and tile.
// - Shared memory: q 9,216 + k and v 2 x 2 x 9,216 = 46,080 bytes (static),
//   4 blocks an SM at 128 registers. Deterministic: no atomics, no split
//   over keys, as a graph replay must be bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kD = 72;
constexpr int kRows = 64;                  // query rows of a block
constexpr int kKeys = 64;                  // keys of a tile
constexpr int kThreads = 128;              // 4 warps of 16 rows
constexpr int kChunks = kD * 2 / 16;       // 16-byte pieces of a row: 9
constexpr int kTile = kRows * kD;          // bf16 of a 64-row tile
constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows == kKeys, "one loader for query and key tiles");

// n / d for n < 2^31 by a multiply and a shift: s = ceil(log2 d),
// m = 2^32 (2^s - d) / d + 1.
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (uint32_t)m, s};
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  return (uint32_t)(((uint64_t)__umulhi(n, f.m) + n) >> f.s);
}

// One side's token grid: a frame's grid is grid_w tokens wide; a window is
// win_h x win_w tokens (n = their product), row-major inside it.
struct Grid {
  int grid_w, win_h;
  FastDiv n, w;
};

struct Params {
  const uint16_t *q, *k, *v;
  uint16_t* o;
  long long q_sb, kv_sb, o_sb;     // elements between frames
  int q_st, kv_st, o_st;           // elements between tokens
  Grid gq, gk;                     // queries (and the output), keys
  FastDiv heads, nwin, nwx;        // heads; windows of a frame; a row's
  uint32_t items;                  // frames x windows x heads
  float scale;
};

// Element offset of token `flat` (items end to end, `gr.n` tokens each).
__device__ __forceinline__ long long offset_of(const Params& p, const Grid& gr,
                                               long long sb, int st,
                                               uint32_t flat) {
  const uint32_t u = fdiv(flat, gr.n), i = flat - u * gr.n.d;
  const uint32_t bw = fdiv(u, p.heads), h = u - bw * p.heads.d;
  const uint32_t b = fdiv(bw, p.nwin), win = bw - b * p.nwin.d;
  const uint32_t wy = fdiv(win, p.nwx), wx = win - wy * p.nwx.d;
  const uint32_t iy = fdiv(i, gr.w), ix = i - iy * gr.w.d;
  const long long y = (long long)wy * gr.win_h + iy;
  const long long x = (long long)wx * gr.w.d + ix;
  return (long long)b * sb + (y * gr.grid_w + x) * st + (long long)h * kD;
}

// This thread's share of one 64-row tile: row tid / 2, its 16-byte pieces
// 0-4 (even threads) or 5-8 (odd); zeros where the row is not valid.
__device__ __forceinline__ void load_row(uint16_t* tile, const uint16_t* src,
                                         long long off, bool valid) {
  const int row = threadIdx.x >> 1, c0 = (threadIdx.x & 1) ? 5 : 0;
  const int c1 = (threadIdx.x & 1) ? kChunks : 5;
  uint16_t* dst = tile + row * kD;
  for (int c = c0; c < c1; ++c)
    svt::cp_async16(dst + 8 * c, valid ? src + off + 8 * c : src, valid);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(svt::smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(svt::smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(svt::smem_u32(p)));
}

// d (16x8, f32) += a (16x8, bf16: rows g, g+8, columns 2t, 2t+1) * b (8x8,
// bf16: k rows 2t, 2t+1 of column g).
__device__ __forceinline__ void mma_bf16_1688(float* d, const uint32_t* a,
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// grid (ceil(items Nq / 64)), 128 threads; see the header note.
__device__ __forceinline__ void attend(const Params& p) {
  __shared__ __align__(128) uint16_t sm[5 * kTile];
  uint16_t* Qs = sm;
  uint16_t* Ks = sm + kTile;         // two stages
  uint16_t* Vs = sm + 3 * kTile;     // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t nq = p.gq.n.d, nk = p.gk.n.d;
  const uint32_t rows = p.items * nq;
  const uint32_t r0 = blockIdx.x * kRows;
  const uint32_t last = min(r0 + kRows, rows) - 1;
  const uint32_t kbeg = fdiv(r0, p.gq.n) * nk;
  const uint32_t kend = (fdiv(last, p.gq.n) + 1) * nk;
  const int tiles = (int)((kend - kbeg + kKeys - 1) / kKeys);

  // This warp's rows and the keys they read; this lane's rows g and g + 8
  // read keys [lo, hi) (empty past the last row).
  const uint32_t wr0 = r0 + 16 * warp;
  const bool has_rows = wr0 < rows;
  uint32_t wlo = 0, whi = 0, lo[2] = {0, 0}, hi[2] = {0, 0};
  bool one_item = false;
  if (has_rows) {
    const uint32_t a = fdiv(wr0, p.gq.n);
    const uint32_t b = fdiv(min(wr0 + 16, rows) - 1, p.gq.n);
    wlo = a * nk;
    whi = (b + 1) * nk;
    one_item = a == b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t row = wr0 + g + 8 * h;
      if (row < rows) {
        lo[h] = fdiv(row, p.gq.n) * nk;
        hi[h] = lo[h] + nk;
      }
    }
  }

  // Queries, then key tile 0.
  {
    const uint32_t row = r0 + (tid >> 1);
    const bool valid = row < rows;
    load_row(Qs, p.q, valid ? offset_of(p, p.gq, p.q_sb, p.q_st, row) : 0,
             valid);
  }
  auto load_keys = [&](int j) {
    const uint32_t key = kbeg + j * kKeys + (tid >> 1);
    const bool valid = key < kend;
    const long long off =
        valid ? offset_of(p, p.gk, p.kv_sb, p.kv_st, key) : 0;
    load_row(Ks + (j & 1) * kTile, p.k, off, valid);
    load_row(Vs + (j & 1) * kTile, p.v, off, valid);
  };
  load_keys(0);
  svt::cp_async_commit();

  const float scale = p.scale, scale_log2 = p.scale * kLog2e;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  float acc[9][4];
#pragma unroll
  for (int n = 0; n < 9; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qa[4][4], qa8[2];

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) load_keys(j + 1);
    svt::cp_async_commit();
    svt::cp_async_wait<1>();
    __syncthreads();
    const uint32_t kt0 = kbeg + j * kKeys;
    if (j == 0 && has_rows) {
      const uint16_t* qrow = Qs + (16 * warp + (lane & 15)) * kD;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        svt::ldmatrix_x4(qa[kk], qrow + 16 * kk + 8 * (lane >> 4));
      ldmatrix_x2(qa8, qrow + 64);
    }
    if (has_rows && kt0 < whi && kt0 + kKeys > wlo) {
      const uint16_t* kb = Ks + (j & 1) * kTile;
      const uint16_t* vb = Vs + (j & 1) * kTile;
      // 1. s = q k^T: 8 tiles of 8 keys, D as 4 k16 steps and one k8.
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          svt::ldmatrix_x4(b, kb + (16 * jp + 8 * (lane >> 4) + (lane & 7)) * kD +
                                  16 * kk + 8 * ((lane >> 3) & 1));
          svt::mma_bf16_16816(s[2 * jp], qa[kk], b);
          svt::mma_bf16_16816(s[2 * jp + 1], qa[kk], b + 2);
        }
      }
#pragma unroll
      for (int jq = 0; jq < 2; ++jq) {
        uint32_t b[4];
        svt::ldmatrix_x4(b, kb + (32 * jq + 8 * (lane >> 3) + (lane & 7)) * kD + 64);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_bf16_1688(s[4 * jq + u], qa8, b[u]);
      }

      // 2. The mask (unless the whole tile is this warp's one item's), the
      //    online softmax, p in place of s.
      if (!(one_item && kt0 >= wlo && kt0 + kKeys <= whi)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t key = kt0 + 8 * n + 2 * t + (e & 1);
            if (key < lo[e >> 1] || key >= hi[e >> 1]) s[n][e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float alpha[2], mb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = mx[h];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[h], x * scale);
        alpha[h] = m_new == m[h] ? 1.f : svt::ex2((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        mb[h] = m_new * kLog2e;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = svt::ex2(fmaf(s[n][e], scale_log2, -mb[e >> 1]));
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
      for (int n = 0; n < 9; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

      // 3. acc += p v: 4 k16 steps of keys, 9 n8 tiles of D.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {
            svt::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            svt::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            svt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            svt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint16_t* vrow =
            vb + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kD;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + 8 * (2 * np + (lane >> 4)));
          svt::mma_bf16_16816(acc[2 * np], a, b);
          svt::mma_bf16_16816(acc[2 * np + 1], a, b + 2);
        }
        uint32_t b[2];
        ldmatrix_x2_trans(b, vrow + 64);
        svt::mma_bf16_16816(acc[8], a, b);
      }
    }
    __syncthreads();  // stage j & 1 is free for tile j + 2
  }

  // out = acc / l, rounded once to bf16; rows past the last are not stored.
  if (!has_rows) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const uint32_t row = wr0 + g + 8 * h;
    if (row >= rows) continue;
    uint16_t* orow = p.o + offset_of(p, p.gq, p.o_sb, p.o_st, row) + 2 * t;
#pragma unroll
    for (int n = 0; n < 9; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          svt::pack_bf16(acc[n][2 * h] / lr, acc[n][2 * h + 1] / lr);
  }
}

__global__ void __launch_bounds__(kThreads, 4) window_attn_kernel(const Params p) {
  attend(p);
}

__global__ void __launch_bounds__(kThreads, 4) flash_d72_kernel(const Params p) {
  attend(p);
}

Grid make_grid(int grid_w, int win_w, int win_h) {
  return Grid{grid_w, win_h, make_div((uint32_t)(win_w * win_h)),
              make_div((uint32_t)win_w)};
}

}  // namespace

// q, k, v, out: bf16, 16-byte aligned, every stride a multiple of 8
// elements. Token (y, x) of frame b, head h, at ptr + b sb + (y grid_w + x)
// st + 72 h; a frame holds nwy x nwx windows of each side's win_h x win_w
// tokens (the query side's grid and windows are the output's). global_ = 1
// launches flash_d72_kernel, 0 window_attn_kernel (the same code). Returns
// cudaGetLastError() of the launch.
extern "C" int svt_window_attention(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    int q_st, long long kv_sb, int kv_st, long long o_sb, int o_st, int frames,
    int heads, int nwy, int nwx, int q_grid_w, int q_win_h, int q_win_w,
    int k_grid_w, int k_win_h, int k_win_w, int global_, float scale,
    void* stream) {
  if (frames <= 0 || heads <= 0 || nwy <= 0 || nwx <= 0 || q_win_h <= 0 ||
      q_win_w <= 0 || k_win_h <= 0 || k_win_w <= 0)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)frames * nwy * nwx * heads;
  const long long nq = (long long)q_win_h * q_win_w;
  const long long nk = (long long)k_win_h * k_win_w;
  if (items * nq >= (1ll << 31) - kRows || items * nk >= (1ll << 31) - kKeys)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.o = static_cast<uint16_t*>(out);
  p.q_sb = q_sb;
  p.kv_sb = kv_sb;
  p.o_sb = o_sb;
  p.q_st = q_st;
  p.kv_st = kv_st;
  p.o_st = o_st;
  p.gq = make_grid(q_grid_w, q_win_w, q_win_h);
  p.gk = make_grid(k_grid_w, k_win_w, k_win_h);
  p.heads = make_div((uint32_t)heads);
  p.nwin = make_div((uint32_t)(nwy * nwx));
  p.nwx = make_div((uint32_t)nwx);
  p.items = (uint32_t)items;
  p.scale = scale;
  const dim3 grid((unsigned)((items * nq + kRows - 1) / kRows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (global_)
    flash_d72_kernel<<<grid, kThreads, 0, s>>>(p);
  else
    window_attn_kernel<<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
