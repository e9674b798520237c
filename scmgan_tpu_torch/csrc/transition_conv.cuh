// One circular 3x3 conv of the bf16 transition step as a Hopper kernel: the
// template behind csrc/fused_transition.cu.  Each output tile width is
// instantiated in its own translation unit (transition_h*.cu,
// transition_head.cu) so that the parallel nvcc calls share the build.
//
// An implicit GEMM: M = the batch's pixels, N = the output channels, K =
// 9 taps x the input channels, bf16 products summed in f32.  One launch
// computes one N tile of BN <= 128 channels (the accumulators of 128 fill a
// thread's registers), from channel n_off of a layer ldo channels wide; a
// wider layer is several launches (fused_transition.cu's tile plan).
//
// Block: three warpgroups, one block an SM, a persistent walk over tiles.
//   * Tile: up to 256 output pixels of one image -- whole rows when W <= 64
//     (4 rows at W = 64), else 4 rows x 64 columns -- so a tile never
//     straddles two images and partial tiles are masked.
//   * A (activations): the consumers copy the tile's input rows y0-1 ..
//     y0+R (taken mod H) x the row's pixels (x-halo taken mod W) x one chunk
//     of up to 64 channels into shared memory with cp.async, once per chunk,
//     double-buffered one chunk ahead.  All 9 taps read that one copy:
//     ldmatrix takes per-lane row addresses, so a tap's shift and the x-wrap
//     are address arithmetic, and L2 -> SM traffic for A is (R+2)/R of the
//     activation instead of 9x.  The 16-byte chunk j of pixel slot p sits at
//     j ^ (p & 7), so ldmatrix's eight rows hit eight bank groups.
//   * A goes to wgmma from registers (a shifted row cannot be a shared
//     memory descriptor): the ldmatrix x4 fragment of 16 rows x 16 K is the
//     per-warp A fragment of wgmma m64nNk16.
//   * B (weights): one producer thread streams (chunk, tap) tiles of BN rows
//     x 64 K (rows n_off .. n_off + BN - 1 of the layout
//     pack_transition_weights emits as "k1".."k6") by TMA
//     with the 128-byte swizzle into a ring of mbarrier-guarded stages; the
//     consumers read them through wgmma descriptors.  One block's 256-pixel
//     tile reuses every weight tile for 4 m64 products.
//   * Two consumer warpgroups, two m64 tiles each (128 accumulator
//     registers a thread at N = 128, after setmaxnreg moves registers from
//     the producer warpgroup).  Each m64 tile's wgmmas of a tap form one
//     commit group; a tile's A registers are reloaded only after its group
//     has completed, while the other tile's group runs.
//   * Epilogue in registers: bias from shared memory (conv1: plus the
//     per-sample bias of the one-hot action half, a sum over taps of its
//     weights, since the conv of a spatially constant map is constant; its
//     (actions, N) table is read from global memory once a tile, so any
//     action count fits),
//     leaky-ReLU or sigmoid with the threshold or Philox head, bf16 pairs
//     through stmatrix into a per-warp staging tile, 16-byte global stores.
//
// The conv5/conv6 skip concat is a second K segment read from a second
// tensor; conv1 reads only the latents.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace scm_tr {

using namespace scm;

enum Head { LRELU = 0, THRESHOLD = 1, SAMPLE = 2 };

constexpr int CONSUMERS = 256;          // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and the producer warpgroup
constexpr int TILE_M = 256;             // output pixels a tile
constexpr int CHUNK = 64;               // input channels a K chunk (128 bytes a pixel)
constexpr int A_SLOTS = 6 * 66;         // input pixels a chunk buffer holds
constexpr int A_BYTES = A_SLOTS * 128;

struct ConvArgs {
  const __nv_bfloat16* in0;   // NHWC, c0 channels
  const __nv_bfloat16* in1;   // NHWC, c1 channels (second K segment), or null
  const float* bias;          // (ldo)
  const float* act;           // (batch, actions) one-hot, conv1 only (else null)
  const float* wact;          // (actions, ldo): conv1's action weights summed over taps
  __nv_bfloat16* out;         // NHWC, ldo channels
  int batch, height, width;
  int c0, c1;                 // channels of each K segment (multiples of 16)
  int ldo, n_off;             // the layer's output channels; this tile's first
  int actions;
  int tw, tws, rows;          // tile width, input slots a row, tile rows
  int row_blocks, col_blocks; // tiles per image
  unsigned long long seed;    // sample head
};

constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block may take
constexpr int MAX_STAGES = 32;

// Shared memory of one block: the weight ring first (1024-byte aligned
// stages), then both A chunk buffers, the per-warp epilogue staging tiles,
// biases and barriers.  The ring takes what the rest leaves, up to 32 stages.
template <int BN>
struct Layout {
  static constexpr int STAGE_BYTES = BN * 128;
  static constexpr int STG_PITCH = BN * 2 + 16;           // staging row, bytes
  static constexpr int REST = 2 * A_BYTES + 8 * 16 * STG_PITCH + 3 * BN * 4 +
                              2 * MAX_STAGES * 8 + 1024;
  static constexpr int STAGES = (SMEM_MAX - REST) / STAGE_BYTES < MAX_STAGES
                                    ? (SMEM_MAX - REST) / STAGE_BYTES : MAX_STAGES;
  static constexpr int B_OFF = 0;
  static constexpr int A_OFF = B_OFF + STAGES * STAGE_BYTES;
  static constexpr int STG_OFF = A_OFF + 2 * A_BYTES;
  static constexpr int BIAS_OFF = STG_OFF + 8 * 16 * STG_PITCH;
  static constexpr int BIAS2_OFF = BIAS_OFF + BN * 4;       // [2][BN]: per tile
  static constexpr int BAR_OFF = BIAS2_OFF + 2 * BN * 4;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;              // room to align the base
  static_assert(STAGES >= 4 && ALLOC <= SMEM_MAX, "shared memory layout");
};

__device__ __forceinline__ int mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// Whether a hidden-layer instantiation compiles chunks of kc k16 steps.  A
// K segment of c channels cuts into 64-channel chunks (4 steps) and a tail
// of c % 64 / 16.  KANY = 0 compiles what a layer of the tile's own width
// reads -- conv1's 16 latents (1), whole chunks and the width's tail -- and
// nothing more, since a compiled chunk size it never reads cost h128 1%
// (nine taps of wgmma unrolled); KANY = 1 compiles all four, for the N
// tiles of wider layers and conv1 at other latent widths.  The head takes
// any input either way.
template <int BN, int HEAD, int KANY>
__host__ __device__ constexpr bool compiles_chunk(int kc) {
  return HEAD != LRELU || KANY || kc == 1 || (kc == 4 && BN >= 64) || kc == BN % 64 / 16;
}

// One K chunk (KC k16 steps of one 64-channel slice) through all 9 taps for
// this thread's warpgroup: two m64 x BN accumulators.  A fragments come from
// the chunk's shared input rows by ldmatrix at the tap's shifted pixel slots;
// B is stage `stage` of the weight ring, released once both of the tap's
// wgmma groups have completed.  KC is a template argument so that each tap's
// wgmmas are straight-line code (ptxas fences wgmmas under a branch).
template <int BN, int KC>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][BN / 2], uint32_t abuf,
                                          const int (&rbase)[2], const int (&col)[2][3],
                                          int tws, int lane, uint32_t b_stages,
                                          uint64_t* full, uint64_t* empty, int& stage,
                                          uint32_t& phase) {
  using L = Layout<BN>;
  uint32_t frag[2][KC][4];               // [m-tile][k16 step]
  auto load = [&](int i, int tap) {
    const int slot = rbase[i] + (tap / 3) * tws + col[i][tap % 3];
    const uint32_t row = abuf + slot * 128;
    const int sw = slot & 7;
#pragma unroll
    for (int ks = 0; ks < KC; ++ks)
      ldmatrix_x4(frag[i][ks], row + (((2 * ks + (lane >> 4)) ^ sw) << 4));
  };
  auto issue = [&](int i, uint64_t desc) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC; ++ks) WgmmaRS<BN>::run(acc[i], frag[i][ks], desc + 2 * ks);
    wgmma_commit();
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  // One wgmma group per m-tile; each group's fragments reload while the
  // other m-tile's group runs, so the warpgroup always has one in flight.
  int prev = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    if (tap > 0) wgmma_wait<1>();    // m-tile 0 of the previous tap is done
    load(0, tap);
    mbar_wait(&full[stage], phase);
    const uint64_t desc = desc_sw128(b_stages + stage * L::STAGE_BYTES);
    issue(0, desc);
    if (tap > 0) {
      wgmma_wait<1>();               // m-tile 1 of the previous tap is done
      release(prev);
    }
    load(1, tap);
    issue(1, desc);
    prev = stage;
    if (++stage == L::STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  release(prev);
}

template <int BN, int HEAD, int KANY>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma(const ConvArgs p, const __grid_constant__ CUtensorMap wmap) {
  using L = Layout<BN>;
  constexpr int NACC = BN / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte aligned base (the 128-byte swizzle repeats every 1024 bytes).
  const uint32_t raw_s = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const uint32_t base_s = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;

  const int tid = threadIdx.x;
  const int H = p.height, W = p.width;
  const int n0 = (p.c0 + CHUNK - 1) / CHUNK, n1 = (p.c1 + CHUNK - 1) / CHUNK;
  const int nchunks = n0 + n1;
  const int tiles_per_image = p.row_blocks * p.col_blocks;
  const int tiles = p.batch * tiles_per_image;

  for (int i = tid; i < BN; i += THREADS) bias_s[i] = p.bias[p.n_off + i];
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer: weight tiles by TMA ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int c = 0; c < nchunks; ++c)
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], L::STAGE_BYTES);
            tma_load_2d(base_s + L::B_OFF + stage * L::STAGE_BYTES, &wmap, &full[stage], 0,
                        (c * 9 + tap) * p.ldo + p.n_off);
            if (++stage == L::STAGES) { stage = 0; phase ^= 1; }
          }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ctid = tid;                       // 0..255
  const int wg = ctid >> 7;                   // consumer warpgroup 0 / 1
  const int cwarp = ctid >> 5;                // 0..7
  const int wq = cwarp & 3, lane = ctid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int TW = p.tw, TWS = p.tws, R = p.rows;
  const bool whole_rows = TWS == TW;          // W <= 64: the x-halo wraps inside the row
  const uint32_t a_base = base_s + L::A_OFF;

  // Tile coordinates.
  auto tile_origin = [&](int tile, int& b, int& y0, int& x0) {
    b = tile / tiles_per_image;
    const int t = tile % tiles_per_image;
    y0 = (t / p.col_blocks) * R;
    x0 = (t % p.col_blocks) * 64;
  };

  // cp.async of chunk c of tile `tile` into A buffer `buf`.
  auto load_a = [&](int tile, int c, int buf) {
    int b, y0, x0;
    tile_origin(tile, b, y0, x0);
    const int r_eff = min(R, H - y0);
    const bool seg0 = c < n0;
    const int cseg = seg0 ? p.c0 : p.c1;
    const int start = (seg0 ? c : c - n0) * CHUNK;
    const int pieces = min(CHUNK, cseg - start) / 8;
    const __nv_bfloat16* src = (seg0 ? p.in0 : p.in1) + start;
    const int n = (r_eff + 2) * TWS * pieces;
    const uint32_t dst0 = a_base + buf * A_BYTES;
    for (int i = ctid; i < n; i += CONSUMERS) {
      const int slot = i / pieces, j = i - slot * pieces;
      const int r = slot / TWS, s = slot - r * TWS;
      const int y = mod(y0 - 1 + r, H);
      const int x = whole_rows ? s : mod(x0 - 1 + s, W);
      const long long pix = ((long long)b * H + y) * W + x;
      cp_async_16(dst0 + slot * 128 + ((j ^ (slot & 7)) << 4), src + pix * cseg + j * 8);
    }
    cp_async_commit();
  };

  // This thread's A rows: pixel m of m-tile i is row (lane & 15) of warp wq.
  int first = blockIdx.x;
  if (first < tiles) load_a(first, 0, 0);
  int it = 0;                                  // chunk iterations so far (A buffer parity)
  int stage = 0;
  uint32_t phase = 0;
  uint8_t* stg = smem + L::STG_OFF + cwarp * 16 * L::STG_PITCH;

  const uint32_t b_stages = base_s + L::B_OFF;
  float* bias2_s = reinterpret_cast<float*>(smem + L::BIAS2_OFF);
  int tile_it = 0;
  for (int tile = first; tile < tiles; tile += gridDim.x, ++tile_it) {
    int b, y0, x0;
    tile_origin(tile, b, y0, x0);
    const int r_eff = min(R, H - y0), w_eff = min(TW, W - x0);

    // Per m-tile: the slot of the pixel's input row above (tap row 0) and
    // its three tap columns.
    int rbase[2], col[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wg * 128 + i * 64 + wq * 16 + (lane & 15);
      int r = m / TW, x = m - r * TW;
      if (r >= r_eff || x >= w_eff) r = x = 0;    // masked row: any valid slot
      rbase[i] = r * TWS;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        col[i][dx] = whole_rows ? mod(x + dx - 1, W) : x + dx;
    }

    float acc[2][NACC];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[i][j] = 0.f;

    // This tile's bias (conv1: plus the per-sample action bias), in the
    // half of bias2_s that the previous tile's epilogue does not read; the
    // chunk barrier below publishes it.  The action terms' loads go out
    // eight at a time: the table misses L1 (shared memory takes nearly all
    // of it), so a group costs one trip to L2, not one an action.
    float* tbias = bias2_s + (tile_it & 1) * BN;
    for (int ch = ctid; ch < BN; ch += CONSUMERS) {
      float v = bias_s[ch];
      if (p.act != nullptr) {
        const float* arow = p.act + (long long)b * p.actions;
        for (int a0 = 0; a0 < p.actions; a0 += 8) {
          float x[8] = {}, w[8] = {};
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (a0 + k < p.actions) {
              x[k] = arow[a0 + k];
              w[k] = p.wact[(a0 + k) * p.ldo + p.n_off + ch];
            }
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (a0 + k < p.actions) v += x[k] * w[k];
        }
      }
      tbias[ch] = v;
    }

    for (int c = 0; c < nchunks; ++c, ++it) {
      // This chunk's A is in (every consumer waited for its own copies);
      // every consumer is done reading the other buffer.
      cp_async_wait_all();
      named_barrier(1, CONSUMERS);
      if (c + 1 < nchunks) load_a(tile, c + 1, (it + 1) & 1);
      else if (tile + (int)gridDim.x < tiles) load_a(tile + gridDim.x, 0, (it + 1) & 1);

      const bool seg0 = c < n0;
      const int kc = min(CHUNK, (seg0 ? p.c0 : p.c1) - (seg0 ? c : c - n0) * CHUNK) / 16;
      const uint32_t abuf = a_base + (it & 1) * A_BYTES;
      // Every K segment is a multiple of 16 channels, so a chunk is 16, 32,
      // 48 or 64 channels: each chunk's ldmatrix reads only the channels its
      // copy wrote.  Only the chunk sizes compiles_chunk names are compiled
      // in; the host picks KANY so that no other size reaches the kernel.
      if (kc == 1) {
        chunk_mma<BN, 1>(acc, abuf, rbase, col, TWS, lane, b_stages, full, empty, stage, phase);
      } else if (kc == 2) {
        if constexpr (compiles_chunk<BN, HEAD, KANY>(2))
          chunk_mma<BN, 2>(acc, abuf, rbase, col, TWS, lane, b_stages, full, empty, stage, phase);
        else
          __trap();
      } else if (kc == 3) {
        if constexpr (compiles_chunk<BN, HEAD, KANY>(3))
          chunk_mma<BN, 3>(acc, abuf, rbase, col, TWS, lane, b_stages, full, empty, stage, phase);
        else
          __trap();
      } else {
        if constexpr (compiles_chunk<BN, HEAD, KANY>(4))
          chunk_mma<BN, 4>(acc, abuf, rbase, col, TWS, lane, b_stages, full, empty, stage, phase);
        else
          __trap();
      }
    }

    // ---------------- epilogue ----------------
    float bsum[NACC / 2];   // bias of this thread's channels 8j + 2 t4 + e
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) bsum[2 * j + e] = tbias[8 * j + 2 * t4 + e];

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mrow0 = wg * 128 + i * 64 + wq * 16;
      // activation and bf16 pairs: rows g (h = 0) and g + 8 (h = 1)
      uint32_t packed[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y[2];
          const int m = mrow0 + g + 8 * h;
          const int r = m / TW, x = m - (m / TW) * TW;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[i][4 * j + 2 * h + e] + bsum[2 * j + e];
            if (HEAD == LRELU) {
              y[e] = v >= 0.f ? v : 0.01f * v;
            } else {
              const float prob = 1.f / (1.f + expf(-v));
              if (HEAD == THRESHOLD) {
                y[e] = prob > 0.5f ? 1.f : 0.f;
              } else {
                // the element's flat index in (B, H, W, ldo): the bits do
                // not depend on the tiling
                const long long gm = ((long long)b * H + y0 + r) * W + x0 + x;
                const float u = philox_uniform(
                    (unsigned long long)gm * p.ldo + p.n_off + 8 * j + 2 * t4 + e, p.seed);
                y[e] = u < prob ? 1.f : 0.f;
              }
            }
          }
          packed[j][h] = pack_bf16x2(y[0], y[1]);
        }
      // stmatrix: 16 rows x BN channels into this warp's staging tile
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const uint32_t addr = smem_u32(stg) + ((mi & 1) * 8 + rr) * L::STG_PITCH +
                              (j + (mi >> 1)) * 16;
        stmatrix_x4(addr, packed[j][0], packed[j][1], packed[j + 1][0], packed[j + 1][1]);
      }
      __syncwarp();
      constexpr int VEC = BN / 8;      // 16-byte vectors a pixel
      for (int v = lane; v < 16 * VEC; v += 32) {
        const int row = v / VEC, q = v - row * VEC;
        const int m = mrow0 + row;
        const int r = m / TW, x = m - r * TW;
        if (r < r_eff && x < w_eff) {
          const long long gm = ((long long)b * H + y0 + r) * W + x0 + x;
          *reinterpret_cast<uint4*>(p.out + gm * p.ldo + p.n_off + q * 8) =
              *reinterpret_cast<const uint4*>(stg + row * L::STG_PITCH + q * 16);
        }
      }
      __syncwarp();
    }
  }
}

// Launch over a persistent grid (one block an SM).
template <int BN, int HEAD, int KANY>
cudaError_t launch_conv(const ConvArgs& a, const CUtensorMap& wmap, cudaStream_t stream) {
  using L = Layout<BN>;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_wgmma<BN, HEAD, KANY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long tiles = (long long)a.batch * a.row_blocks * a.col_blocks;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv3x3_wgmma<BN, HEAD, KANY><<<grid, THREADS, L::ALLOC, stream>>>(a, wmap);
  return cudaGetLastError();
}

}  // namespace scm_tr
