// The serving decoder, both convs in one launch, for sm_90a.
//
// Replaces: scmgan_tpu/ops/pallas/fused_decoder.py, fused_decode /
// fused_decode_packed (pallas_call at :126): a zero-padded SAME 3x3 conv
// latent (16) -> hidden (64), leaky-ReLU, and a SAME 3x3 conv hidden -> color
// (1-4) whose weights already hold the transposed-conv flip and the
// per-factor sum, with the (H, W, 64) intermediate kept out of device memory.
//
// What bounds it on the H100: operations, narrowly -- 0.09 GFLOP per image
// against 128 KB of bf16 latents in and 24 KB of bf16 logits out, about 590
// FLOP per byte at the bf16 tensor-core rate (the ridge is about 295), some
// 9 microseconds at B = 100.  What held the first kernel far from that was
// not the bound: f32 FMAs on the CUDA cores, 100 KB of f32 weights converted
// by every one of 1,600 blocks (two blocks an SM), and conv2 as one thread
// per pixel through 576 serial steps.
//
// What the design does about it:
//   * both convs run on bf16 tensor cores with f32 sums (mma.sync m16n8k16,
//     A fragments by ldmatrix, B fragments by 32-bit shared reads);
//   * a persistent grid: each block stages the weights once, in bf16
//     (18 KB + 9 KB, transposed so a B fragment is one 32-bit read, and
//     swizzled against bank conflicts), then walks output tiles of 16 rows x
//     32 columns;
//   * per tile the 20x36x16 input halo (zero outside the image: SAME
//     padding) sits in shared memory; the 18x34 intermediate is computed 16
//     channels at a time (zero outside the image), and conv2 adds each
//     16-channel slice into f32 accumulators held in registers, so the
//     intermediate needs 19.6 KB and not 78 KB.  The halo recompute is
//     624/512 = 1.22x (612 intermediate pixels in 39 16-row MMA tiles), and
//     about 70 KB of shared memory and at most 80 registers a thread let
//     three blocks share an SM;
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

constexpr int LAT = 16;              // latent channels in
constexpr int HID = 64;              // intermediate channels
constexpr int MAXC = 4;              // colors out
constexpr int NC = 8;                // colors padded to one MMA n-tile
constexpr int TH = 16, TW = 32;      // output tile
constexpr int MH = TH + 2, MW = TW + 2;            // intermediate tile 18 x 34
constexpr int IH = TH + 4, IW = TW + 4;            // input tile 20 x 36
constexpr int MID_PIX = MH * MW;                   // 612
constexpr int MID_TILES = (MID_PIX + 15) / 16;     // 39 MMA row tiles
constexpr int SLICE = 16;                          // intermediate channels per pass
constexpr int PASSES = HID / SLICE;                // 4
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int PIX_B = 32;                          // bytes per pixel row in shared memory
constexpr int W1_BYTES = 9 * HID * LAT * 2;        // [tap][co][ci], swizzled
constexpr int W2_BYTES = 9 * NC * HID * 2;         // [tap][color][ci], swizzled
constexpr int IN_BYTES = IH * IW * PIX_B;
constexpr int MID_BYTES = MID_PIX * PIX_B;
constexpr size_t SMEM_BYTES = W1_BYTES + W2_BYTES + IN_BYTES + MID_BYTES +
                              sizeof(float) * (HID + NC);

// Element offsets of the weights in shared memory: rows of K (input
// channels), their 8-channel groups permuted by row so that the eight rows a
// B fragment read touches fall on distinct banks.
__device__ __forceinline__ int w1_off(int tap, int co, int ci) {
  return (tap * HID + co) * LAT + (((ci >> 3) ^ ((co >> 2) & 1)) << 3) + (ci & 7);
}
__device__ __forceinline__ int w2_off(int tap, int c, int ci) {
  return (tap * NC + c) * HID + (((ci >> 3) ^ (c & 7)) << 3) + (ci & 7);
}

// Byte offset of 16-byte half `h` of pixel row `p` (the bank swizzle).
__device__ __forceinline__ int pix_off(int p, int h) {
  return p * PIX_B + ((h ^ ((p >> 2) & 1)) << 4);
}

// Input halo of tile (b, ty0, tx0) into shared memory as bf16, zero outside
// the image.
__device__ __forceinline__ void load_input(unsigned char* in_s, const float* __restrict__ z,
                                           int b, int ty0, int tx0, int H, int W) {
  for (int i = threadIdx.x; i < IH * IW * 2; i += THREADS) {
    const int p = i >> 1, h = i & 1;
    const int gy = ty0 - 2 + p / IW, gx = tx0 - 2 + p % IW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float4* src = reinterpret_cast<const float4*>(
          z + (((long long)b * H + gy) * W + gx) * LAT + h * 8);
      const float4 f0 = src[0], f1 = src[1];
      v = make_uint4(pack_bf16x2(f0.x, f0.y), pack_bf16x2(f0.z, f0.w),
                     pack_bf16x2(f1.x, f1.y), pack_bf16x2(f1.z, f1.w));
    }
    *reinterpret_cast<uint4*>(in_s + pix_off(p, h)) = v;
  }
}

__global__ void __launch_bounds__(THREADS, 3)
decode_kernel(const float* __restrict__ z,
              const __nv_bfloat16* __restrict__ w1,   // (9, LAT, HID)
              const float* __restrict__ b1,           // (HID)
              const __nv_bfloat16* __restrict__ w2,   // (9, HID, color)
              const float* __restrict__ b2,           // (color)
              __nv_bfloat16* __restrict__ out,        // (B, H, W, color)
              int batch, int H, int W, int color) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);           // [tap][co][ci]
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + W1_BYTES); // [tap][c][ci]
  unsigned char* in_s = smem + W1_BYTES + W2_BYTES;
  unsigned char* mid_s = in_s + IN_BYTES;
  float* b1s = reinterpret_cast<float*>(mid_s + MID_BYTES);
  float* b2s = b1s + HID;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // Weights once per block, transposed so that K (input channels) is
  // contiguous: a B fragment pair is one 32-bit read.
  for (int i = tid; i < 9 * LAT * HID; i += THREADS) {
    const int co = i % HID, ci = (i / HID) % LAT, tap = i / (HID * LAT);
    w1s[w1_off(tap, co, ci)] = w1[i];
  }
  for (int i = tid; i < 9 * NC * HID; i += THREADS) {
    const int ci = i % HID, c = (i / HID) % NC, tap = i / (HID * NC);
    w2s[w2_off(tap, c, ci)] =
        c < color ? w2[(tap * HID + ci) * color + c] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < HID; i += THREADS) b1s[i] = b1[i];
  if (tid < NC) b2s[tid] = tid < color ? b2[tid] : 0.f;

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int tiles = batch * tiles_y * tiles_x;
  auto tile_coords = [&](int tile, int& b, int& ty0, int& tx0) {
    tx0 = (tile % tiles_x) * TW;
    ty0 = ((tile / tiles_x) % tiles_y) * TH;
    b = tile / (tiles_x * tiles_y);
  };

  int tile = blockIdx.x;
  if (tile < tiles) {
    int b, ty0, tx0;
    tile_coords(tile, b, ty0, tx0);
    load_input(in_s, z, b, ty0, tx0, H, W);
  }

  for (; tile < tiles; tile += gridDim.x) {
    int b, ty0, tx0;
    tile_coords(tile, b, ty0, tx0);
    float acc2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;

    for (int pass = 0; pass < PASSES; ++pass) {
      __syncthreads();   // input (and, after pass 0, the previous pass's reads of mid_s) done

      // conv1, intermediate channels [16 pass, 16 pass + 16): 39 row tiles
      // x 2 n-tiles x 9 taps.
      // Two row tiles at a time: four independent MMA chains.
      for (int mt0 = warp; mt0 < MID_TILES; mt0 += 2 * WARPS) {
        float acc[2][2][4] = {};
        int pix[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          int q = (mt0 + u * WARPS) * 16 + (lane & 15);
          q = q < MID_PIX ? q : MID_PIX - 1;
          pix[u] = (q / MW) * IW + q % MW;
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint32_t bw[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int co = pass * SLICE + j * 8 + g;
            bw[j][0] = *reinterpret_cast<const uint32_t*>(w1s + w1_off(tap, co, 2 * t4));
            bw[j][1] = *reinterpret_cast<const uint32_t*>(w1s + w1_off(tap, co, 2 * t4 + 8));
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t a[4];
            ldmatrix_x4(a, smem_u32(in_s + pix_off(pix[u] + (tap / 3) * IW + tap % 3,
                                                   lane >> 4)));
            mma_bf16_16816(acc[u][0], a, bw[0][0], bw[0][1]);
            mma_bf16_16816(acc[u][1], a, bw[1][0], bw[1][1]);
          }
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
              const int ch = pass * SLICE + j * 8 + 2 * t4;
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
      __syncthreads();   // the slice is whole; the input is no longer read

      // The next tile's input, while this tile's last conv2 slice runs.
      if (pass == PASSES - 1 && tile + (int)gridDim.x < tiles) {
        int nb, nty0, ntx0;
        tile_coords(tile + gridDim.x, nb, nty0, ntx0);
        load_input(in_s, z, nb, nty0, ntx0, H, W);
      }

      // conv2, K slice = 9 taps x these 16 channels; 32 output row tiles,
      // four per warp.
      // Tap-major over the warp's four output row tiles: four independent
      // MMA chains.
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ci = pass * SLICE + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(w2s + w2_off(tap, g, ci));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(w2s + w2_off(tap, g, ci + 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ot = warp + i * WARPS;
          const int q = ((ot >> 1) + tap / 3) * MW + (ot & 1) * 16 + (lane & 15) + tap % 3;
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(mid_s + pix_off(q, lane >> 4)));
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

}  // namespace

// z (B,H,W,16) f32 -> out (B,H,W,color) bf16 logits.  Weights are the
// (9, Cin, Cout) bf16 stacks of pack_decoder_weights, biases f32.
extern "C" int scm_decode(const void* z, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out,
                          int batch, int height, int width, int latent,
                          int hidden, int color, void* stream_handle) {
  if (latent != LAT || hidden != HID || color < 1 || color > MAXC ||
      batch < 1 || height < 1 || width < 1 ||
      (long long)batch * ((height + TH - 1) / TH) * ((width + TW - 1) / TW) > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_kernel, THREADS, SMEM_BYTES)) != cudaSuccess)
    return (int)e;
  const long long tiles = (long long)batch * ((height + TH - 1) / TH) *
                          ((width + TW - 1) / TW);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  decode_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream_handle>>>(
      (const float*)z, (const __nv_bfloat16*)w1, (const float*)b1,
      (const __nv_bfloat16*)w2, (const float*)b2, (__nv_bfloat16*)out,
      batch, height, width, color);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a decoder block takes.
extern "C" int scm_decode_smem() { return (int)SMEM_BYTES; }
