// One circular 3x3 conv of the int8 (w8a8) transition step as a Hopper
// kernel: the template behind csrc/int8_transition.cu.  Each output tile
// width is instantiated in its own translation unit (int8_h*.cu,
// int8_head.cu) so that the parallel nvcc calls share the build.
//
// An implicit GEMM: M = the batch's pixels, N = the output channels, K =
// 9 taps x the input channels, s8 x s8 products summed exactly in s32.  One
// launch computes one N tile of BN <= 128 channels, from channel n_off of a
// layer ldo channels wide (int8_transition.cu's tile plan).  The
// design is the bf16 kernel's (transition_conv.cuh), whose byte layout
// carries over: wgmma's depth is 32 bytes for both types (k16 bf16, k32 s8).
//
// Block: three warpgroups, one block an SM, a persistent walk over tiles.
//   * Tile: up to 256 output pixels of one image (128 for a split-order
//     conv at N >= 80, below) -- whole rows when W <= 64, else rows of 64
//     columns -- so a tile never straddles two images and partial tiles are
//     masked.
//   * A (activations): three producer warps copy the tile's input rows
//     y0-1 .. y0+R (taken mod H) x the row's pixels (x-halo taken mod W) x
//     one K segment -- an input tensor, or 128 channels of a wider one (one
//     128-byte slot a pixel) -- into shared memory with cp.async, once per
//     K segment, into a double
//     buffer guarded by mbarriers (a_full: every copy landed, counted by
//     cp.async.mbarrier.arrive; a_empty: every consumer warp is done), so
//     the consumers spend no instructions on it and never wait for each
//     other.  All 9 taps read that one copy through ldmatrix with per-lane
//     row addresses, so a tap's shift and the x-wrap are address arithmetic
//     and the L2 -> SM traffic for A is (R+2)/R of the activation.  The
//     16-byte unit j of pixel slot p sits at j ^ (p & 7).
//   * K plan: K runs over (tap, 16-channel unit) in pairs, one k32 step a
//     pair, so a pair may span two taps (lanes 0-15 give ldmatrix the first
//     unit's row addresses, lanes 16-31 the second's).  A segment of u units
//     takes ceil(9u / 2) steps: 14 at hidden 48 (27 units), 5 for conv1's
//     16 latent channels.  Every segment starts a new step; the split orders
//     add the segments of the main tensor into one sum and those of the
//     U-Net skip (conv5/conv6's second tensor) into another.
//   * A goes to wgmma from registers: the ldmatrix x4 fragment (16 rows x
//     32 bytes) is the per-warp A fragment of wgmma m64nNk32 s8.
//   * B (weights): one producer thread streams 128-byte K tiles (4 steps)
//     of the tile's BN output channels (rows n_off .. n_off + BN - 1 of the
//     layout pack_kernel_weights emits) by TMA
//     with the 128-byte swizzle into a ring of mbarrier-guarded stages; the
//     consumers read them through wgmma descriptors.
//   * Two consumer warpgroups.  Joint sums: two m64 tiles each, every
//     weight tile reused by four m64 products.  Split orders ((pa*sa +
//     pb*sb) + b and (pa*sa + b) + pb*sb) keep each segment's sums in its
//     own registers: two tiles x two segments at N <= 64, one tile x two
//     segments at N >= 80 (128-pixel tiles), so nothing is parked in
//     shared memory.  Each m-tile's wgmmas on one weight tile are one commit
//     group; its A registers are reloaded only after it has completed,
//     while the next group runs.
//   * Epilogue in registers, the plain version's f32 roundings one by one
//     (__fmul_rn / __fadd_rn, no FMA contraction): dequant, bias, and
//     leaky-ReLU + round-half-even requant to +-127 (hidden layers) or the
//     logit / sigmoid / Philox head (conv6); int8 pairs into a per-warp
//     staging tile, then 16-byte global stores.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace scm_i8 {

using namespace scm;

enum Order { JOINT = 0, SUM_FIRST = 1, BIAS_FIRST = 2 };
enum Head { REQUANT = 0, LOGIT = 1, SIGMOID = 2, SAMPLE = 3 };

constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and the producer warpgroup
constexpr int LOADERS = 96;              // producer threads that copy activations
constexpr int UNIT = 16;                 // channels (bytes) of one K unit
constexpr int SEG_UNITS = 8;             // units of a K segment at most (one 128-byte slot)
constexpr int A_SLOTS = 6 * 66;          // input pixels a segment buffer holds
constexpr int A_BYTES = A_SLOTS * 128;
constexpr int SMEM_MAX = 232448;         // dynamic shared memory a block may take
constexpr int MAX_STAGES = 32;

// K of one segment of u units (all 9 taps): k32 steps of two units, and
// 128-byte weight tiles of four steps.
__host__ __device__ constexpr int seg_steps(int u) { return (9 * u + 1) / 2; }
__host__ __device__ constexpr int seg_tiles(int u) { return (seg_steps(u) + 3) / 4; }

struct ConvArgs {
  const signed char* in0;   // NHWC, c0 channels
  const signed char* in1;   // NHWC, c1 channels (the U-Net skip), or null
  const float* scale0;      // (ldo): the joint scale, or in0's
  const float* scale1;      // (ldo): in1's (split orders), else null
  const float* bias;        // (ldo)
  const float* requant;     // (ldo): hidden layers; null for the head
  const float* act;         // (batch, actions) one-hot, conv1 only (else null)
  const int* wact;          // (actions, ldo): conv1's action weights summed over taps
  signed char* out;         // NHWC, ldo channels
  int batch, height, width, actions;
  int c0, c1;               // channels of each input tensor: multiples of 16
  int ldo, n_off;           // the layer's output channels; this tile's first
  int order, head;          // head: REQUANT for conv1-5, LOGIT / SIGMOID / SAMPLE for conv6
  int tw, tws, rows;        // tile width, input slots a row, tile rows
  int row_blocks, col_blocks;
  unsigned long long seed;  // sample head
};

// K segment s of a conv whose input tensors hold u0 and u1 units: each
// tensor in segments of SEG_UNITS units and the rest, in0's first.  t: the
// tensor; off: its first channel; u: its units.
struct Seg {
  int t, off, u;
};
__host__ __device__ inline int seg_count(int u) { return (u + SEG_UNITS - 1) / SEG_UNITS; }
__host__ __device__ inline Seg seg_of(int s, int u0, int u1) {
  const int n0 = seg_count(u0);
  const int t = s < n0 ? 0 : 1, q = t ? s - n0 : s, ut = t ? u1 : u0;
  const int u = ut - q * SEG_UNITS < SEG_UNITS ? ut - q * SEG_UNITS : SEG_UNITS;
  return {t, q * SEG_UNITS * UNIT, u};
}

// What a consumer warpgroup holds: MT m64 tiles, each with one s32 sum
// (joint) or one per input tensor (split orders).  Two split tiles at N >= 80
// would take 2 x 2 x N/2 accumulator registers a thread, so there it holds
// one and the block's tile is 128 pixels.
template <int BN, int SPLIT>
struct Shape {
  static constexpr int MT = (SPLIT && BN >= 80) ? 1 : 2;
  static constexpr int NS = SPLIT ? 2 : 1;
  static constexpr int TILE_M = 128 * MT;
  typedef int Acc[MT][NS][BN / 2];
};

// Shared memory of one block: the weight ring first (1024-byte aligned
// stages), then both A segment buffers, the per-warp staging tiles, the
// per-channel parameters, each warpgroup's per-tile int32 bias of conv1's
// action half, and the barriers.  The ring takes what the rest leaves, up
// to 32 stages.
template <int BN>
struct Layout {
  static constexpr int STAGE_BYTES = BN * 128;
  // staging row: a multiple of 16 bytes, an odd multiple of 16 words, so
  // the eight rows of a warp's pair stores fall on distinct banks
  static constexpr int STG_PITCH = (BN / 16) % 2 ? BN : BN + 16;
  static constexpr int REST = 2 * A_BYTES + 8 * 16 * STG_PITCH + 8 * BN * 4 +
                              (2 * MAX_STAGES + 4) * 8 + 1024;
  static constexpr int STAGES = (SMEM_MAX - REST) / STAGE_BYTES < MAX_STAGES
                                    ? (SMEM_MAX - REST) / STAGE_BYTES : MAX_STAGES;
  static constexpr int B_OFF = 0;
  static constexpr int A_OFF = B_OFF + STAGES * STAGE_BYTES;
  static constexpr int STG_OFF = A_OFF + 2 * A_BYTES;
  static constexpr int PAR_OFF = STG_OFF + 8 * 16 * STG_PITCH;  // [4][BN] f32
  static constexpr int EXTRA_OFF = PAR_OFF + 4 * BN * 4;        // [2 wg][2 tiles][BN] s32
  static constexpr int BAR_OFF = EXTRA_OFF + 4 * BN * 4;
  // full[STAGES], empty[STAGES], a_full[2], a_empty[2]
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 4) * 8;
  static constexpr int ALLOC = BYTES + 1024;                    // room to align the base
  static_assert(STAGES >= 4 && ALLOC <= SMEM_MAX, "shared memory layout");
};

__device__ __forceinline__ int mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float sigmoid(float y) {
  return 1.f / (1.f + expf(-y));
}

// One K segment of U units, all 9 taps, into sum S of each of this
// warpgroup's MT m64 tiles.  A fragments come from the segment's shared input
// rows by ldmatrix at each unit's tap-shifted pixel slot; B is the ring's
// stages, one per weight tile, released once every group on it has
// completed.  U is a template argument so that every wgmma is straight-line
// code (ptxas fences wgmmas under a branch).
template <int BN, int SPLIT, int U, int S>
__device__ __forceinline__ void segment_mma(typename Shape<BN, SPLIT>::Acc& acc, uint32_t abuf,
                                            const int (&rbase)[Shape<BN, SPLIT>::MT],
                                            const int (&col)[Shape<BN, SPLIT>::MT][3],
                                            int tws, int lane, uint32_t b_stages,
                                            uint64_t* full, uint64_t* empty, int& stage,
                                            uint32_t& phase) {
  using L = Layout<BN>;
  constexpr int MT = Shape<BN, SPLIT>::MT;
  constexpr int NB = 2;                  // A fragment buffers
  constexpr int STEPS = seg_steps(U), TILES = seg_tiles(U);
  const bool hi = lane >= 16;
  uint32_t frag[NB][4][4];               // [buffer][k32 step of the tile]
  auto load = [&](int buf, int i, int t) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = 4 * t + k;
      if (s < STEPS) {
        // units 2s and 2s + 1; a padding unit past the segment's end reads
        // any valid slot (its weights are zero)
        const int v0 = 2 * s, v1 = 2 * s + 1 < 9 * U ? 2 * s + 1 : 9 * U - 1;
        const int t0 = v0 / U, t1 = v1 / U;
        const int slot = rbase[i] + (hi ? (t1 / 3) * tws + col[i][t1 % 3]
                                         : (t0 / 3) * tws + col[i][t0 % 3]);
        const int j = hi ? v1 - t1 * U : v0 - t0 * U;
        ldmatrix_x4(frag[buf][k], abuf + slot * 128 + ((j ^ (slot & 7)) << 4));
      }
    }
  };
  auto issue = [&](int buf, int i, int t, uint64_t desc) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * t + k < STEPS) WgmmaS8<BN>::run(acc[i][S], frag[buf][k], desc + 2 * k);
    wgmma_commit();
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  // One commit group per (weight tile t, m-tile i): group g = t * MT + i.
  // Its fragments sit in buffer g % NB, loaded while group g - 1 runs; a
  // weight tile's stage is released once its last group has completed.
  constexpr int G = TILES * MT;
  int ring[TILES];                       // the ring stage of each weight tile
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int t = g / MT, i = g % MT;
    if (g >= NB) {
      wgmma_wait<NB - 1>();              // groups up to g - NB are done
      if ((g - NB + 1) % MT == 0 && g - NB + 1 >= MT) release(ring[(g - NB + 1) / MT - 1]);
    }
    load(g % NB, i, t);
    if (i == 0) {
      ring[t] = stage;
      mbar_wait(&full[stage], phase);
      if (++stage == L::STAGES) { stage = 0; phase ^= 1; }
    }
    issue(g % NB, i, t, desc_sw128(b_stages + ring[t] * L::STAGE_BYTES));
  }
  wgmma_wait<0>();
  // the tiles not released in the loop: those with a group after G - 1 - NB
#pragma unroll
  for (int t = 0; t < TILES; ++t)
    if (t * MT + MT - 1 > G - 1 - NB) release(ring[t]);
}

// The segment's unit count picks the straight-line code.  GEN = 0 compiles
// what a layer of the tile's own width reads -- conv1's 16 latent channels
// (1 unit) and the width (BN / 16) -- and nothing more (lengths compiled in
// and never read cost time: eight cost the head launch about 6% over four).
// GEN = 1, and N = 16 (the head, and the hidden layers at hidden 16),
// compile every length of 1 to 8 units, for the N tiles of wider layers,
// their split K and conv1 at other latent widths.  The host picks GEN so
// that no other length reaches the kernel.
template <int BN, int SPLIT, int GEN, int S>
__device__ __forceinline__ void segment(int u, typename Shape<BN, SPLIT>::Acc& acc,
                                        uint32_t abuf,
                                        const int (&rbase)[Shape<BN, SPLIT>::MT],
                                        const int (&col)[Shape<BN, SPLIT>::MT][3],
                                        int tws, int lane, uint32_t b_stages, uint64_t* full,
                                        uint64_t* empty, int& stage, uint32_t& phase) {
#define SCM_SEG(UU)                                                              \
  segment_mma<BN, SPLIT, UU, S>(acc, abuf, rbase, col, tws, lane, b_stages, full, \
                                 empty, stage, phase)
  if constexpr (BN == 16 || GEN) {
    switch (u) {
      case 1: SCM_SEG(1); break;
      case 2: SCM_SEG(2); break;
      case 3: SCM_SEG(3); break;
      case 4: SCM_SEG(4); break;
      case 5: SCM_SEG(5); break;
      case 6: SCM_SEG(6); break;
      case 7: SCM_SEG(7); break;
      default: SCM_SEG(8);
    }
  } else if constexpr (!SPLIT) {
    if (u == 1) SCM_SEG(1);
    else SCM_SEG(BN / 16);
  } else {
    SCM_SEG(BN / 16);
  }
#undef SCM_SEG
}

// GEN = 0: each input tensor is one K segment (at most 128 channels) of a
// length a layer of the tile's own width reads, the shipped widths' case,
// whose bookkeeping stays compile-time simple (the general form cost every
// launch about 2 µs); GEN = 1: tensors of any width, in segments of 128
// channels and the rest (seg_of), of any length.
template <int BN, int SPLIT, int GEN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_s8(const ConvArgs p, const __grid_constant__ CUtensorMap wmap) {
  using L = Layout<BN>;
  constexpr int MT = Shape<BN, SPLIT>::MT, NS = Shape<BN, SPLIT>::NS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte aligned base (the 128-byte swizzle repeats every 1024 bytes).
  const uint32_t raw_s = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const uint32_t base_s = smem_u32(smem);
  float* par_s = reinterpret_cast<float*>(smem + L::PAR_OFF);  // scale0 scale1 bias requant
  int* extra_s = reinterpret_cast<int*>(smem + L::EXTRA_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* a_full = empty + L::STAGES;    // [2]: an A buffer's copies have landed
  uint64_t* a_empty = a_full + 2;          // [2]: every consumer warp is done with it

  const int tid = threadIdx.x;
  const int H = p.height, W = p.width;
  const int u0 = p.c0 / UNIT, u1 = p.c1 / UNIT;
  const int nseg = GEN ? seg_count(u0) + seg_count(u1) : (u1 > 0 ? 2 : 1);
  auto seg_at = [&](int s) -> Seg {
    return GEN ? seg_of(s, u0, u1) : Seg{s, 0, s == 0 ? u0 : u1};
  };
  const int tiles_per_image = p.row_blocks * p.col_blocks;
  const int tiles = p.batch * tiles_per_image;
  const int TW = p.tw, TWS = p.tws, R = p.rows;
  const bool whole_rows = TWS == TW;          // W <= 64: the x-halo wraps inside the row
  auto tile_origin = [&](int tile, int& b, int& y0, int& x0) {
    b = tile / tiles_per_image;
    const int t = tile % tiles_per_image;
    y0 = (t / p.col_blocks) * R;
    x0 = (t % p.col_blocks) * 64;
  };

  for (int i = tid; i < BN; i += THREADS) {
    const int n = p.n_off + i;
    par_s[i] = p.scale0[n];
    par_s[BN + i] = SPLIT ? p.scale1[n] : 0.f;
    par_s[2 * BN + i] = p.bias[n];
    par_s[3 * BN + i] = p.requant != nullptr ? p.requant[n] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&a_full[s], LOADERS);
      mbar_init(&a_empty[s], CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int ptid = tid - CONSUMERS;
    if (ptid == 0) {
      // weight tiles by TMA
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int ktiles = 0;
      if (GEN)
        for (int seg = 0; seg < nseg; ++seg) ktiles += seg_tiles(seg_of(seg, u0, u1).u);
      else
        ktiles = seg_tiles(u0) + (u1 > 0 ? seg_tiles(u1) : 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int t = 0; t < ktiles; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], L::STAGE_BYTES);
          tma_load_2d(base_s + L::B_OFF + stage * L::STAGE_BYTES, &wmap, &full[stage], 0,
                      t * p.ldo + p.n_off);
          if (++stage == L::STAGES) { stage = 0; phase ^= 1; }
        }
    } else if (ptid >= 32) {
      // activations: each segment's input rows into the next A buffer, once
      // both warpgroups are done with what it held.  Loader l copies units
      // l, l + 96, ... of the (row, slot, unit) order -- neighbouring threads
      // on neighbouring 16 bytes -- stepping (unit, slot, row) without a
      // division; its copies' completion is its arrival on a_full.
      const int l = ptid - 32;
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, y0, x0;
        tile_origin(tile, b, y0, x0);
        const int r_eff = min(R, H - y0);
        for (int seg = 0; seg < nseg; ++seg, ++it) {
          const int buf = it & 1;
          mbar_wait(&a_empty[buf], ((it >> 1) & 1) ^ 1);
          const Seg sg = seg_at(seg);
          // c: the tensor's pixel stride
          const int u = sg.u, c = GEN ? (sg.t ? p.c1 : p.c0) : u * UNIT;
          const signed char* src = (sg.t ? p.in1 : p.in0) + (long long)b * H * W * c + sg.off;
          const int n = (r_eff + 2) * TWS * u;
          const uint32_t dst0 = base_s + L::A_OFF + buf * A_BYTES;
          const int dslot = LOADERS / u, dj = LOADERS - dslot * u;
          const int dr = dslot / TWS, ds = dslot - dr * TWS;
          int slot = l / u, j = l - slot * u;
          int r = slot / TWS, sc = slot - r * TWS;
          for (int i = l; i < n; i += LOADERS) {
            int y = y0 - 1 + r, x = whole_rows ? sc : x0 - 1 + sc;
            y = y < 0 ? y + H : (y >= H ? y - H : y);     // y0-1 .. y0+r_eff, mod H
            x = x < 0 ? x + W : (x >= W ? x - W : x);
            cp_async_16(dst0 + slot * 128 + ((j ^ (slot & 7)) << 4),
                        src + ((long long)y * W + x) * c + j * UNIT);
            j += dj; slot += dslot; sc += ds; r += dr;
            if (j >= u) { j -= u; ++slot; ++sc; }
            if (sc >= TWS) { sc -= TWS; ++r; }
          }
          cp_async_mbar_arrive(&a_full[buf]);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int ctid = tid;                       // 0..255
  const int wg = ctid >> 7;                   // consumer warpgroup 0 / 1
  const int cwarp = ctid >> 5;                // 0..7
  const int wq = cwarp & 3, lane = ctid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t a_base = base_s + L::A_OFF;

  // Row (pixel) of m-tile i's first row for this warp.
  auto mrow = [&](int i) { return MT == 2 ? wg * 128 + i * 64 + wq * 16 : wg * 64 + wq * 16; };

  // This thread's A rows (pixel m of m-tile i is row lane & 15 of warp
  // wq), the same in every tile: row r, column x of the tile, and the slots
  // of its three tap columns.
  int row_of[MT], x_of[MT], col_of[MT][3];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = mrow(i) + (lane & 15);
    row_of[i] = m / TW;
    x_of[i] = m - row_of[i] * TW;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      col_of[i][dx] = whole_rows ? mod(x_of[i] + dx - 1, W) : x_of[i] + dx;
  }

  int it = 0;                                  // segment iterations so far (A buffer parity)
  int stage = 0;
  uint32_t phase = 0;
  uint8_t* stg = smem + L::STG_OFF + cwarp * 16 * L::STG_PITCH;
  const uint32_t b_stages = base_s + L::B_OFF;
  int tile_it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tile_it) {
    int b, y0, x0;
    tile_origin(tile, b, y0, x0);
    const int r_eff = min(R, H - y0), w_eff = min(TW, W - x0);

    // Per m-tile: the slot of the pixel's input row above (tap row 0) and
    // its three tap columns; a masked row reads row 0, column 0's.
    int rbase[MT], col[MT][3];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const bool live = row_of[i] < r_eff && x_of[i] < w_eff;
      rbase[i] = live ? row_of[i] * TWS : 0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        col[i][dx] = live ? col_of[i][dx] : (whole_rows ? mod(dx - 1, W) : dx);
    }

    // conv1: this sample's action half as an int32 bias (the conv of a
    // spatially constant one-hot map is its weights summed over taps), in
    // this warpgroup's half of extra_s for this tile's parity.
    int* tex = extra_s + (wg * 2 + (tile_it & 1)) * BN;
    for (int ch = ctid & 127; ch < BN; ch += 128) {
      int v = 0;
      if (p.act != nullptr)
        for (int a = 0; a < p.actions; ++a)
          v += (int)p.act[(long long)b * p.actions + a] * p.wact[a * p.ldo + p.n_off + ch];
      tex[ch] = v;
    }
    named_barrier(2 + wg, 128);
    // the sums start from that bias (zero elsewhere)
    typename Shape<BN, SPLIT>::Acc acc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 ex = *reinterpret_cast<const int2*>(tex + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[i][s][4 * j + k] = s == 0 ? (k & 1 ? ex.y : ex.x) : 0;
    }

    for (int seg = 0; seg < nseg; ++seg, ++it) {
      const int buf = it & 1;
      mbar_wait(&a_full[buf], (it >> 1) & 1);
      const uint32_t abuf = a_base + buf * A_BYTES;
      const Seg sg = seg_at(seg);
      if (NS == 2 && sg.t == 1)
        segment<BN, SPLIT, GEN, NS - 1>(sg.u, acc, abuf, rbase, col, TWS, lane, b_stages, full,
                                         empty, stage, phase);
      else
        segment<BN, SPLIT, GEN, 0>(sg.u, acc, abuf, rbase, col, TWS, lane, b_stages, full,
                                    empty, stage, phase);
      __syncwarp();
      if (lane == 0) mbar_arrive(&a_empty[buf]);
    }

    // ---------------- epilogue ----------------
    // Output pixel of tile row m (false: masked).  Whole rows are contiguous
    // pixels; past W = 64 a tile row is 64 columns.
    const long long gm0 = ((long long)b * H + y0) * W + x0;
    auto pixel = [&](int m, long long& gm) {
      if (whole_rows) {
        gm = gm0 + m;
        return m < r_eff * TW;
      }
      const int r = m >> 6, x = m & 63;
      gm = gm0 + (long long)r * W + x;
      return r < r_eff && x < w_eff;
    };
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mrow0 = mrow(i);
      // rows g (h = 0) and g + 8 (h = 1); channels 8j + 2 t4 + e
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = 8 * j + 2 * t4;
        const float2 s0 = *reinterpret_cast<const float2*>(par_s + n);
        const float2 s1 = *reinterpret_cast<const float2*>(par_s + BN + n);
        const float2 bs = *reinterpret_cast<const float2*>(par_s + 2 * BN + n);
        const float2 rq = *reinterpret_cast<const float2*>(par_s + 3 * BN + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t q[2];    // the output byte in bits 0-7
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * j + 2 * h + e;
            const float sc0 = e ? s0.y : s0.x, bias = e ? bs.y : bs.x;
            float y;
            if (NS == 1) {
              y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][0][k]), sc0), bias);
            } else {
              const float ya = __fmul_rn(__int2float_rn(acc[i][0][k]), sc0);
              const float yb = __fmul_rn(__int2float_rn(acc[i][NS - 1][k]), e ? s1.y : s1.x);
              y = p.order == SUM_FIRST ? __fadd_rn(__fadd_rn(ya, yb), bias)
                                       : __fadd_rn(__fadd_rn(ya, bias), yb);
            }
            if (BN != 16 || p.head == REQUANT) {
              // leaky-ReLU (max(y, 0.01 y) is y for y >= 0, else 0.01 y),
              // requant, then clamp to +-127 and round half to even by
              // adding 1.5 * 2^23: the sum's low byte is the int8 (for
              // finite values, clamping first gives the same integer)
              const float l = fmaxf(y, __fmul_rn(0.01f, y));
              const float v = fminf(fmaxf(__fmul_rn(l, e ? rq.y : rq.x), -127.f), 127.f);
              q[e] = __float_as_uint(__fadd_rn(v, 12582912.f));
            } else if (p.head == LOGIT) {
              q[e] = y > 0.f;
            } else if (p.head == SIGMOID) {
              // 1 / x > 0.5 exactly when x < 2, for the rounded x = 1 + e^-y
              q[e] = __fadd_rn(1.f, expf(-y)) < 2.f;
            } else {
              long long gm;
              pixel(mrow0 + g + 8 * h, gm);
              // the element's flat index in (B, H, W, ldo): the bits do
              // not depend on the tiling
              q[e] = philox_uniform((unsigned long long)gm * p.ldo + p.n_off + n + e, p.seed) <
                     sigmoid(y);
            }
          }
          *reinterpret_cast<uint16_t*>(stg + (g + 8 * h) * L::STG_PITCH + n) =
              (uint16_t)__byte_perm(q[0], q[1], 0x0040);
        }
      }
      __syncwarp();
      constexpr int VEC = BN / 16;      // 16-byte vectors a pixel
      for (int v = lane; v < 16 * VEC; v += 32) {
        const int row = v / VEC, qv = v - row * VEC;
        long long gm;
        if (pixel(mrow0 + row, gm))
          *reinterpret_cast<uint4*>(p.out + gm * p.ldo + p.n_off + qv * 16) =
              *reinterpret_cast<const uint4*>(stg + row * L::STG_PITCH + qv * 16);
      }
      __syncwarp();
    }
  }
}

// Launch over a persistent grid (one block an SM).
template <int BN, int SPLIT, int GEN>
cudaError_t launch_conv(const ConvArgs& a, const CUtensorMap& wmap, cudaStream_t stream) {
  using L = Layout<BN>;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_s8<BN, SPLIT, GEN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long tiles = (long long)a.batch * a.row_blocks * a.col_blocks;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv3x3_s8<BN, SPLIT, GEN><<<grid, THREADS, L::ALLOC, stream>>>(a, wmap);
  return cudaGetLastError();
}

}  // namespace scm_i8
