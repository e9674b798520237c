// The serving decoder, both convs in one launch, for sm_90a.
//
// Replaces: scmgan_tpu/ops/pallas/fused_decoder.py, fused_decode /
// fused_decode_packed (pallas_call at :126): a zero-padded SAME 3x3 conv
// latent (L) -> hidden (4L), leaky-ReLU, and a SAME 3x3 conv hidden -> color
// (1-4) whose weights already hold the transposed-conv flip and the
// per-factor sum, with the (H, W, 4L) intermediate kept out of device memory.
// Both widths run zero-padded to multiples of 16 (pack_decoder_weights).
//
// What bounds it on the H100: operations, narrowly -- at L = 16, 0.09 GFLOP
// per image against 128 KB of bf16 latents in and 24 KB of bf16 logits out,
// about 590 FLOP per byte at the bf16 tensor-core rate (the ridge is about
// 295), some 9 microseconds at B = 100.  What held the first kernel far from that was
// not the bound: f32 FMAs on the CUDA cores, 100 KB of f32 weights converted
// by every one of 1,600 blocks (two blocks an SM), and conv2 as one thread
// per pixel through 576 serial steps.
//
// What the design does about it:
//   * both convs run on bf16 tensor cores with f32 sums (mma.sync m16n8k16,
//     A fragments by ldmatrix, B fragments by 32-bit shared reads);
//   * a persistent grid: each block walks output tiles of 16 rows x 32
//     columns.  It stages the weights in bf16 (transposed so a B fragment
//     is one 32-bit read, and swizzled against bank conflicts) once when
//     they are small (L <= 16: 18 KB + 9 KB at L = 16), else one 16-channel
//     pass of the intermediate at a time, so that shared memory does not
//     grow with the hidden width;
//   * per tile the 20x36 input halo (zero outside the image: SAME padding)
//     sits in shared memory in slices of 16 channels, at most 4 at once; the
//     18x34 intermediate is computed 16 channels at a time (zero outside the
//     image), and conv2 adds each 16-channel slice into f32 accumulators
//     held in registers, so the intermediate needs 19.6 KB whatever its
//     width.  Past 64 latent channels the input is read in groups of 4
//     slices a pass, conv1's partial sums parked in shared memory between
//     them.  The halo recompute is 624/512 = 1.22x (612 intermediate pixels
//     in 39 16-row MMA tiles); at L = 16 about 70 KB of shared memory and at
//     most 80 registers a thread let three blocks share an SM;
//   * shared rows are 32 bytes (16 bf16 channels), the two 16-byte halves
//     swapped on every other group of four pixels, so ldmatrix's eight row
//     addresses fall on distinct banks;
//   * the latents are read as the free-run carries them, in f32, and
//     rounded to bf16 on the way into shared memory: no separate cast pass;
//   * bf16 logits are staged in shared memory and leave in 16-byte stores
//     where a tile row is whole and aligned, else element by element.
//
// Interface: plain C, no PyTorch headers; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

using scm::ldmatrix_x4;
using scm::mma_bf16_16816;
using scm::pack_bf16x2;
using scm::smem_u32;

namespace {

constexpr int MAXC = 4;              // colors out
constexpr int NC = 8;                // colors padded to one MMA n-tile
constexpr int TH = 16, TW = 32;      // output tile
constexpr int MH = TH + 2, MW = TW + 2;            // intermediate tile 18 x 34
constexpr int IH = TH + 4, IW = TW + 4;            // input tile 20 x 36
constexpr int MID_PIX = MH * MW;                   // 612
constexpr int MID_TILES = (MID_PIX + 15) / 16;     // 39 MMA row tiles
constexpr int SLICE = 16;                          // channels of a slice (and a pass)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int PIX_B = 32;                          // bytes per pixel row in shared memory
constexpr int IN_SLICE_BYTES = IH * IW * PIX_B;    // one 16-channel slice of the halo
constexpr int MAX_IN_SLICES = 4;                   // input slices in shared memory at once
constexpr int MID_BYTES = MID_PIX * PIX_B;
// conv1's partial sums between input groups: every (row tile, n-tile, lane)
// of the row tiles the conv1 loop visits (39 rounded up to 2 x WARPS)
constexpr int PART_TILES = 48;
constexpr int PART_BYTES = PART_TILES * 2 * 32 * 4 * 4;
constexpr int W2_PASS_BYTES = 9 * NC * SLICE * 2;  // conv2's weights of one pass
constexpr int WHOLE_MAX = 32 * 1024;               // weights staged once up to this size

// How a decoder of latent_pad inputs and hidden_pad intermediate channels
// runs: the host computes it, the kernel reads it.
struct Plan {
  int ni, np;      // input slices, passes (intermediate slices)
  int gi, ng;      // input slices in shared memory, input groups a pass
  int whole;       // weights staged once a block (else one pass at a time)
  int w1_bytes, w2_bytes, in_bytes, part_bytes;
  size_t smem;
};

Plan make_plan(int latent_pad, int hidden_pad) {
  Plan p;
  p.ni = latent_pad / SLICE;
  p.np = hidden_pad / SLICE;
  p.gi = p.ni < MAX_IN_SLICES ? p.ni : MAX_IN_SLICES;
  p.ng = (p.ni + p.gi - 1) / p.gi;
  const int w1_whole = 9 * hidden_pad * latent_pad * 2, w2_whole = p.np * W2_PASS_BYTES;
  p.whole = p.ng == 1 && w1_whole + w2_whole <= WHOLE_MAX;
  p.w1_bytes = p.whole ? w1_whole : 9 * SLICE * p.gi * SLICE * 2;
  p.w2_bytes = p.whole ? w2_whole : W2_PASS_BYTES;
  p.in_bytes = p.gi * IN_SLICE_BYTES;
  p.part_bytes = p.ng > 1 ? PART_BYTES : 0;
  p.smem = (size_t)p.w1_bytes + p.w2_bytes + p.in_bytes + MID_BYTES + p.part_bytes +
           sizeof(float) * ((p.whole ? p.np : 1) * SLICE + NC);
  return p;
}

// Element offsets of the weights in shared memory, a slot a pass (one slot
// unless staged whole): W1 as [slot][tap][co 16][ci of the group], W2 as
// [slot][tap][color 8][ci 16]; rows of K (input channels), each pair of
// 8-channel groups swapped by row so that the eight rows a B fragment read
// touches fall on distinct banks.
__device__ __forceinline__ int w1_off(int slot, int tap, int co, int ci, int row) {
  return ((slot * 9 + tap) * SLICE + co) * row + (((ci >> 3) ^ ((co >> 2) & 1)) << 3) + (ci & 7);
}
__device__ __forceinline__ int w2_off(int slot, int tap, int c, int ci) {
  return ((slot * 9 + tap) * NC + c) * SLICE + (((ci >> 3) ^ ((c >> 2) & 1)) << 3) + (ci & 7);
}

// Byte offset of 16-byte half `h` of pixel row `p` (the bank swizzle).
__device__ __forceinline__ int pix_off(int p, int h) {
  return p * PIX_B + ((h ^ ((p >> 2) & 1)) << 4);
}

// Input slices s0 .. s0 + ns - 1 of tile (b, ty0, tx0)'s halo into shared
// memory as bf16, zero outside the image.  z holds lp channels a pixel.
__device__ __forceinline__ void load_input(unsigned char* in_s, const float* __restrict__ z,
                                           int b, int ty0, int tx0, int H, int W, int lp,
                                           int s0, int ns) {
  for (int i = threadIdx.x; i < IH * IW * 2 * ns; i += THREADS) {
    const int s = i / (IH * IW * 2), r = i - s * (IH * IW * 2);
    const int p = r >> 1, h = r & 1;
    const int gy = ty0 - 2 + p / IW, gx = tx0 - 2 + p % IW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float4* src = reinterpret_cast<const float4*>(
          z + (((long long)b * H + gy) * W + gx) * lp + (s0 + s) * SLICE + h * 8);
      const float4 f0 = src[0], f1 = src[1];
      v = make_uint4(pack_bf16x2(f0.x, f0.y), pack_bf16x2(f0.z, f0.w),
                     pack_bf16x2(f1.x, f1.y), pack_bf16x2(f1.z, f1.w));
    }
    *reinterpret_cast<uint4*>(in_s + s * IN_SLICE_BYTES + pix_off(p, h)) = v;
  }
}

// NP > 0: latent <= 16 (one input slice, NP passes, the weights staged
// once), every shape of it compile-time, as the shipped decoders' (NP = 4),
// three blocks an SM; NP = 0: any other shape, from the plan, at most two
// blocks an SM (their shared memory allows no more), so 128 registers.
template <int NP>
__global__ void __launch_bounds__(THREADS, NP > 0 ? 3 : 2)
decode_kernel(const float* __restrict__ z,
              const __nv_bfloat16* __restrict__ w1,   // (9, latent_pad, hidden_pad)
              const float* __restrict__ b1,           // (hidden_pad)
              const __nv_bfloat16* __restrict__ w2,   // (9, hidden_pad, color)
              const float* __restrict__ b2,           // (color)
              __nv_bfloat16* __restrict__ out,        // (B, H, W, color)
              int batch, int H, int W, int color, const Plan pl) {
  constexpr bool FIXED = NP > 0;
  const int np = FIXED ? NP : pl.np, ni = FIXED ? 1 : pl.ni;
  const int gi = FIXED ? 1 : pl.gi, ng = FIXED ? 1 : pl.ng;
  const bool whole = FIXED || pl.whole;
  const int lp = ni * SLICE, hp = np * SLICE;
  const int row = gi * SLICE;                    // W1's K row in shared memory
  const int w1_bytes = FIXED ? 9 * NP * SLICE * SLICE * 2 : pl.w1_bytes;
  const int w2_bytes = FIXED ? NP * W2_PASS_BYTES : pl.w2_bytes;
  const int in_bytes = FIXED ? IN_SLICE_BYTES : pl.in_bytes;
  const int part_bytes = FIXED ? 0 : pl.part_bytes;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + w1_bytes);
  unsigned char* in_s = smem + w1_bytes + w2_bytes;
  unsigned char* mid_s = in_s + in_bytes;
  float* part = reinterpret_cast<float*>(mid_s + MID_BYTES);
  float* b1s = reinterpret_cast<float*>(mid_s + MID_BYTES + part_bytes);
  float* b2s = b1s + (whole ? np : 1) * SLICE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // Staged whole: a slot a pass, read contiguously.
  if (whole) {
    for (int i = tid; i < 9 * lp * hp; i += THREADS) {
      const int co = i % hp, ci = (i / hp) % lp, tap = i / (hp * lp);
      w1s[w1_off(co / SLICE, tap, co % SLICE, ci, row)] = w1[i];
    }
    for (int i = tid; i < 9 * NC * hp; i += THREADS) {
      const int ci = i % hp, c = (i / hp) % NC, tap = i / (hp * NC);
      w2s[w2_off(ci / SLICE, tap, c, ci % SLICE)] =
          c < color ? w2[(tap * hp + ci) * color + c] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < hp; i += THREADS) b1s[i] = b1[i];
  }
  // Else pass `pass`'s weights (W1 of input group q; W2 and b1 with q = 0)
  // into slot 0, transposed so that K (input channels) is contiguous.
  auto stage_w1 = [&](int slot, int pass, int q) {
    const int ns = min(gi, ni - q * gi) * SLICE;
    for (int i = tid; i < 9 * ns * SLICE; i += THREADS) {
      const int co = i % SLICE, ci = (i / SLICE) % ns, tap = i / (SLICE * ns);
      w1s[w1_off(slot, tap, co, ci, row)] =
          w1[((long long)tap * lp + q * gi * SLICE + ci) * hp + pass * SLICE + co];
    }
  };
  auto stage_w2 = [&](int slot, int pass) {
    for (int i = tid; i < 9 * SLICE * NC; i += THREADS) {
      const int c = i % NC, ci = (i / NC) % SLICE, tap = i / (NC * SLICE);
      w2s[w2_off(slot, tap, c, ci)] =
          c < color ? w2[((long long)tap * hp + pass * SLICE + ci) * color + c]
                    : __float2bfloat16(0.f);
    }
    for (int i = tid; i < SLICE; i += THREADS) b1s[slot * SLICE + i] = b1[pass * SLICE + i];
  };
  if (tid < NC) b2s[tid] = tid < color ? b2[tid] : 0.f;

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int tiles = batch * tiles_y * tiles_x;
  auto tile_coords = [&](int tile, int& b, int& ty0, int& tx0) {
    tx0 = (tile % tiles_x) * TW;
    ty0 = ((tile / tiles_x) % tiles_y) * TH;
    b = tile / (tiles_x * tiles_y);
  };

  int tile = blockIdx.x;
  if (ng == 1 && tile < tiles) {
    int b, ty0, tx0;
    tile_coords(tile, b, ty0, tx0);
    load_input(in_s, z, b, ty0, tx0, H, W, lp, 0, gi);
  }

  for (; tile < tiles; tile += gridDim.x) {
    int b, ty0, tx0;
    tile_coords(tile, b, ty0, tx0);
    float acc2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;

    for (int pass = 0; pass < np; ++pass) {
      const int slot = whole ? pass : 0;
      for (int q = 0; q < ng; ++q) {
        // the input (and, after pass 0, the previous pass's reads of mid_s
        // and of the staged weights) done
        __syncthreads();
        const int ns = FIXED ? 1 : min(gi, ni - q * gi);
        if (ng > 1) load_input(in_s, z, b, ty0, tx0, H, W, lp, q * gi, ns);
        if (!whole) {
          stage_w1(0, pass, q);
          if (q == 0) stage_w2(0, pass);
        }
        if (ng > 1 || !whole) __syncthreads();

        // conv1, intermediate channels [16 pass, 16 pass + 16) from this
        // group's input slices: 39 row tiles x 2 n-tiles x 9 taps x the
        // slices.  Two row tiles at a time: four independent MMA chains.
        for (int mt0 = warp; mt0 < MID_TILES; mt0 += 2 * WARPS) {
          float acc[2][2][4] = {};
          if (q > 0)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float4 v = *reinterpret_cast<const float4*>(
                    part + (((mt0 + u * WARPS) * 2 + j) * 32 + lane) * 4);
                acc[u][j][0] = v.x; acc[u][j][1] = v.y; acc[u][j][2] = v.z; acc[u][j][3] = v.w;
              }
          int pix[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            int qp = (mt0 + u * WARPS) * 16 + (lane & 15);
            qp = qp < MID_PIX ? qp : MID_PIX - 1;
            pix[u] = (qp / MW) * IW + qp % MW;
          }
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            for (int s = 0; s < ns; ++s) {
              uint32_t bw[2][2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int co = j * 8 + g, ci = s * SLICE + 2 * t4;
                bw[j][0] = *reinterpret_cast<const uint32_t*>(w1s + w1_off(slot, tap, co, ci, row));
                bw[j][1] =
                    *reinterpret_cast<const uint32_t*>(w1s + w1_off(slot, tap, co, ci + 8, row));
              }
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                uint32_t a[4];
                ldmatrix_x4(a, smem_u32(in_s + s * IN_SLICE_BYTES +
                                        pix_off(pix[u] + (tap / 3) * IW + tap % 3, lane >> 4)));
                mma_bf16_16816(acc[u][0], a, bw[0][0], bw[0][1]);
                mma_bf16_16816(acc[u][1], a, bw[1][0], bw[1][1]);
              }
            }
          }
          if (q < ng - 1) {
            // not the last group: park the partial sums (this thread's own)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                *reinterpret_cast<float4*>(part + (((mt0 + u * WARPS) * 2 + j) * 32 + lane) * 4) =
                    make_float4(acc[u][j][0], acc[u][j][1], acc[u][j][2], acc[u][j][3]);
            continue;
          }
          // bias, leaky-ReLU, zero outside the image; rows g and g + 8
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int qq = (mt0 + u * WARPS) * 16 + g + half * 8;
              if (qq >= MID_PIX) continue;
              const int gy = ty0 - 1 + qq / MW, gx = tx0 - 1 + qq % MW;
              const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int ch = slot * SLICE + j * 8 + 2 * t4;
                float v0 = acc[u][j][2 * half] + b1s[ch];
                float v1 = acc[u][j][2 * half + 1] + b1s[ch + 1];
                v0 = v0 >= 0.f ? v0 : 0.01f * v0;
                v1 = v1 >= 0.f ? v1 : 0.01f * v1;
                if (!inside) v0 = v1 = 0.f;
                *reinterpret_cast<uint32_t*>(mid_s + pix_off(qq, j) + 4 * t4) =
                    pack_bf16x2(v0, v1);
              }
            }
        }
      }
      __syncthreads();   // the slice is whole; the input is no longer read

      // The next tile's input, while this tile's last conv2 slice runs.
      if (ng == 1 && pass == np - 1 && tile + (int)gridDim.x < tiles) {
        int nb, nty0, ntx0;
        tile_coords(tile + gridDim.x, nb, nty0, ntx0);
        load_input(in_s, z, nb, nty0, ntx0, H, W, lp, 0, gi);
      }

      // conv2, K slice = 9 taps x these 16 channels; 32 output row tiles,
      // four per warp.
      // Tap-major over the warp's four output row tiles: four independent
      // MMA chains.
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(w2s + w2_off(slot, tap, g, 2 * t4));
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(w2s + w2_off(slot, tap, g, 2 * t4 + 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ot = warp + i * WARPS;
          const int qm = ((ot >> 1) + tap / 3) * MW + (ot & 1) * 16 + (lane & 15) + tap % 3;
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(mid_s + pix_off(qm, lane >> 4)));
          mma_bf16_16816(acc2[i], a, b0, b1);
        }
      }
    }

    // Logits -> bf16, staged in mid_s as [pixel][color], then stored.
    __syncthreads();
    __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(mid_s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ot = warp + i * WARPS;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = ot * 16 + g + half * 8;     // = oy * TW + ox
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * t4 + e;
          if (c < color)
            o_s[px * color + c] = __float2bfloat16(acc2[i][2 * half + e] + b2s[c]);
        }
      }
    }
    __syncthreads();
    const int row_elems = min(TW, W - tx0) * color;
    for (int oy = warp; oy < TH && ty0 + oy < H; oy += WARPS) {
      const long long g0 = (((long long)b * H + ty0 + oy) * W + tx0) * color;
      const __nv_bfloat16* src = o_s + oy * TW * color;
      if ((g0 & 7) == 0 && (row_elems & 7) == 0) {
        for (int v = lane; v < row_elems / 8; v += 32)
          *reinterpret_cast<uint4*>(out + g0 + v * 8) =
              *reinterpret_cast<const uint4*>(src + v * 8);
      } else {
        for (int e = lane; e < row_elems; e += 32) out[g0 + e] = src[e];
      }
    }
  }
}

template <int NP>
int launch(const void* z, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int batch, int height, int width, int color, const Plan& pl,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_kernel<NP>, THREADS, pl.smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)batch * ((height + TH - 1) / TH) *
                          ((width + TW - 1) / TW);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  decode_kernel<NP><<<grid, THREADS, pl.smem, stream>>>(
      (const float*)z, (const __nv_bfloat16*)w1, (const float*)b1,
      (const __nv_bfloat16*)w2, (const float*)b2, (__nv_bfloat16*)out,
      batch, height, width, color, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// z (B,H,W,latent_pad) f32 (the latents zero-padded to a multiple of 16)
// -> out (B,H,W,color) bf16 logits.  w1 (9, latent_pad, hidden_pad) and w2
// (9, hidden_pad, color) are the bf16 kernel operands of
// pack_decoder_weights (zero past the model's widths), b1 (hidden_pad) and
// b2 (color) f32.  Any widths (multiples of 16), 1-4 colours.
extern "C" int scm_decode(const void* z, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out,
                          int batch, int height, int width, int latent_pad,
                          int hidden_pad, int color, void* stream_handle) {
  if (latent_pad < SLICE || latent_pad % SLICE || hidden_pad < SLICE ||
      hidden_pad % SLICE || color < 1 || color > MAXC ||
      batch < 1 || height < 1 || width < 1 ||
      (long long)batch * ((height + TH - 1) / TH) * ((width + TW - 1) / TW) > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(latent_pad, hidden_pad);
  cudaStream_t stream = (cudaStream_t)stream_handle;
#define SCM_LAUNCH(NP) launch<NP>(z, w1, b1, w2, b2, out, batch, height, width, color, pl, stream)
  if (pl.ni > 1) return SCM_LAUNCH(0);
  switch (pl.np) {   // latent <= 16: hidden_pad 16 .. 64
    case 1: return SCM_LAUNCH(1);
    case 2: return SCM_LAUNCH(2);
    case 3: return SCM_LAUNCH(3);
    case 4: return SCM_LAUNCH(4);
    default: return SCM_LAUNCH(0);
  }
#undef SCM_LAUNCH
}

// Dynamic shared memory a decoder block takes at these widths.
extern "C" int scm_decode_smem(int latent_pad, int hidden_pad) {
  return (int)make_plan(latent_pad, hidden_pad).smem;
}
