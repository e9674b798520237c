// One eval/sampling step of the world model's transition, for sm_90a.
//
// Replaces: scmgan_tpu/ops/pallas/fused_transition.py, fused_transition
// (pallas_call at :214), which runs the whole step -- action broadcast, six
// circular 3x3 convs with the U-Net skip concats, leaky-ReLU, sigmoid and the
// threshold or Bernoulli head -- with all six 64x64x128 activations resident
// in a 100 MB VMEM window.
//
// What bounds it on the H100: operations.  One step is 6.5 GFLOP per image
// (K = 9 * Cin up to 2304, N = 128) against about 26 MB of bf16 activations
// read and written per image over all six layers, some 250 FLOP per byte at
// B = 100: near the card's bf16 ridge (about 295 FLOP/byte), and far above it
// if the activations stay in the 50 MB L2.
//
// What the design does about it: an SM holds 227 KB, not the TPU's VMEM, so
// the step is six launches of one implicit-GEMM conv kernel, each writing its
// activation to device memory in bf16 (the layers' reuse of it runs from L2).
// A block computes 128 output pixels x all output channels with bf16 tensor
// core MMAs (WMMA 16x16x16, f32 accumulation), stepping K in 32-channel slices
// of one tap (a tap's last slice zero-filled where Cin is not a multiple of
// 32, as at hidden 48 and 80), double-buffered in shared memory with the next slice's global
// loads in flight during the MMAs.  Circular wrap is index arithmetic in the
// loads (no padded copy); conv1 builds its latent + one-hot action input on
// load (the concat is never stored); conv5 and conv6 read their skip concat
// as a split K over two tensors.  The epilogue adds the bias and applies
// leaky-ReLU (layers 1-5) or sigmoid and the threshold / Philox-sampled head
// (layer 6) before one bf16 store.
//
// Interface: plain C, no PyTorch headers (built by nvcc in seconds and loaded
// with ctypes); every function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
using scm::wrap;

namespace {

constexpr int BM = 128;         // output pixels per block
constexpr int BK = 32;          // K slice: 32 input channels of one tap
constexpr int THREADS = 256;    // 8 warps
constexpr int A_LD = BK + 8;    // shared row pitch in bf16 (80 B: 16 B aligned, skews banks)

enum Head { LRELU = 0, THRESHOLD = 1, SAMPLE = 2 };

struct ConvArgs {
  const __nv_bfloat16* in0;   // NHWC, c0 channels
  const __nv_bfloat16* in1;   // NHWC, cin - c0 channels (split K), or unused
  const float* act;           // (batch, actions) one-hot, first layer only
  const __nv_bfloat16* w;     // (9 * cin, cout), row k = tap * cin + channel
  const float* bias;          // (cout)
  __nv_bfloat16* out;         // NHWC, cout channels
  int batch, height, width;
  int cin;                    // K per tap, a multiple of 8; the first layer's
                              // padded virtual width (a multiple of 32)
  int c0;                     // channels taken from in0 (first layer: latent)
  int actions;                // first layer: one-hot channels after the latent
  int cout;                   // == the block's N tile
  unsigned long long seed;    // sample head
};

// Two blocks per SM: ptxas then caps a thread at 128 registers (a few bytes
// spill), and the second block's loads overlap the first one's MMAs.
template <int BN, bool FIRST, int HEAD>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_circular(const ConvArgs p) {
  constexpr int WARPS_N = (BN >= 64 && BN % 32 == 0) ? 2 : 1;
  constexpr int WARPS_M = 8 / WARPS_N;
  constexpr int WM = BM / WARPS_M;          // rows per warp: 32 or 16
  constexpr int WN = BN / WARPS_N;          // cols per warp: a multiple of 16
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int B_LD = BN + 8;
  constexpr int B_VECS = BK * BN / 8;       // 16-byte vectors per B slice
  constexpr int B_PER_THREAD = (B_VECS + THREADS - 1) / THREADS;

  __shared__ __align__(128) __nv_bfloat16 As[2][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * B_LD];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = p.height, W = p.width, hw = H * W;
  const long long M = (long long)p.batch * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int slices = (p.cin + BK - 1) / BK;   // per tap
  const int ksteps = 9 * slices;

  // A slice: 128 pixels x 4 vectors of 8 channels; thread t loads vector t % 4
  // of pixels t / 4 and t / 4 + 64.
  const int a_vec = tid % 4;
  int a_b[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long gm = m0 + tid / 4 + i * 64;
    a_ok[i] = gm < M;
    const long long g = a_ok[i] ? gm : 0;
    a_b[i] = (int)(g / hw);
    const int r = (int)(g % hw);
    a_y[i] = r / W;
    a_x[i] = r % W;
  }

  uint4 a_reg[2];
  uint4 b_reg[B_PER_THREAD];

  auto load_slice = [&](int ks) {
    const int tap = ks / slices, k0 = (ks % slices) * BK;
    const int cbase = k0 + a_vec * 8;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a_reg[i] = make_uint4(0, 0, 0, 0);
      if (!a_ok[i] || cbase >= p.cin) continue;
      const long long pix =
          ((long long)a_b[i] * H + wrap(a_y[i] + dy, H)) * W + wrap(a_x[i] + dx, W);
      if (FIRST) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cbase + j;
          float f = 0.f;
          if (c < p.c0) f = __bfloat162float(p.in0[pix * p.c0 + c]);
          else if (c < p.c0 + p.actions) f = p.act[(long long)a_b[i] * p.actions + (c - p.c0)];
          v[j] = __float2bfloat16(f);
        }
        a_reg[i] = *reinterpret_cast<const uint4*>(v);
      } else {
        const int c1 = p.cin - p.c0;
        const __nv_bfloat16* src = cbase < p.c0
            ? p.in0 + pix * p.c0 + cbase
            : p.in1 + pix * c1 + (cbase - p.c0);
        a_reg[i] = *reinterpret_cast<const uint4*>(src);
      }
    }
    // rows past the tap's Cin belong to the next tap: zero them
    const __nv_bfloat16* wk = p.w + ((size_t)tap * p.cin + k0) * BN;
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      if (v < B_VECS)
        b_reg[i] = k0 + v / (BN / 8) < p.cin
                       ? *reinterpret_cast<const uint4*>(wk + (size_t)v * 8)
                       : make_uint4(0, 0, 0, 0);
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = tid / 4 + i * 64;
      *reinterpret_cast<uint4*>(&As[buf][row * A_LD + a_vec * 8]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      if (v < B_VECS) {
        const int row = v / (BN / 8), col = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[buf][row * B_LD + col]) = b_reg[i];
      }
    }
  };

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_slice(0);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int buf = ks & 1;
    // Safe to overwrite buf: every warp passed the previous barrier, so it
    // finished the MMAs that read buf two slices ago.
    store_slice(buf);
    __syncthreads();
    if (ks + 1 < ksteps) load_slice(ks + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &As[buf][(wm * WM + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[buf][kk * B_LD + wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }

  // Epilogue: each warp stages one 16x16 f32 tile at a time; lane l finishes
  // 8 consecutive channels of row l / 2 and stores them as one 16-byte write.
  float* st = stage[warp];
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long gm = m0 + wm * WM + i * 16 + r;
      const int col = wn * WN + j * 16 + c8;
      if (gm < M) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = st[r * 16 + c8 + e] + p.bias[col + e];
          float y;
          if (HEAD == LRELU) {
            y = v >= 0.f ? v : 0.01f * v;
          } else {
            const float prob = 1.f / (1.f + expf(-v));
            if (HEAD == THRESHOLD) {
              y = prob > 0.5f ? 1.f : 0.f;
            } else {
              const float u = scm::philox_uniform(
                  (unsigned long long)gm * p.cout + col + e, p.seed);
              y = u < prob ? 1.f : 0.f;
            }
          }
          o[e] = __float2bfloat16(y);
        }
        *reinterpret_cast<uint4*>(p.out + gm * p.cout + col) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

template <int BN, bool FIRST, int HEAD>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const long long M = (long long)a.batch * a.height * a.width;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  conv3x3_circular<BN, FIRST, HEAD><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// The six launches of one step at hidden width HID.
template <int HID>
cudaError_t step(ConvArgs a, const void* z, const void* act,
                 const void* const* w, const void* const* b,
                 void* h1, void* h2, void* h3, void* h4, void* out,
                 int latent, int actions, int cin1, int latent_pad, int sample,
                 cudaStream_t stream) {
  typedef const __nv_bfloat16* In;
  typedef __nv_bfloat16* Out;
  cudaError_t e;

  // conv1: [z | one-hot action | 0] -> h1
  a.in0 = (In)z; a.in1 = nullptr; a.act = (const float*)act;
  a.w = (In)w[0]; a.bias = (const float*)b[0]; a.out = (Out)h1;
  a.cin = cin1; a.c0 = latent; a.actions = actions; a.cout = HID;
  if ((e = launch<HID, true, LRELU>(a, stream)) != cudaSuccess) return e;

  a.act = nullptr; a.actions = 0; a.cin = HID; a.c0 = HID;
  // conv2: h1 -> h2; conv3: h2 -> h3; conv4: h3 -> h4
  a.in0 = (In)h1; a.w = (In)w[1]; a.bias = (const float*)b[1]; a.out = (Out)h2;
  if ((e = launch<HID, false, LRELU>(a, stream)) != cudaSuccess) return e;
  a.in0 = (In)h2; a.w = (In)w[2]; a.bias = (const float*)b[2]; a.out = (Out)h3;
  if ((e = launch<HID, false, LRELU>(a, stream)) != cudaSuccess) return e;
  a.in0 = (In)h3; a.w = (In)w[3]; a.bias = (const float*)b[3]; a.out = (Out)h4;
  if ((e = launch<HID, false, LRELU>(a, stream)) != cudaSuccess) return e;

  // conv5: [h4 | h2] -> h5 (into h3's buffer)
  a.cin = 2 * HID; a.c0 = HID;
  a.in0 = (In)h4; a.in1 = (In)h2; a.w = (In)w[4]; a.bias = (const float*)b[4];
  a.out = (Out)h3;
  if ((e = launch<HID, false, LRELU>(a, stream)) != cudaSuccess) return e;

  // conv6: [h5 | h1] -> sigmoid -> threshold or sample
  a.in0 = (In)h3; a.in1 = (In)h1; a.w = (In)w[5]; a.bias = (const float*)b[5];
  a.out = (Out)out; a.cout = latent_pad;
  return sample ? launch<16, false, SAMPLE>(a, stream)
                : launch<16, false, THRESHOLD>(a, stream);
}

}  // namespace

// One transition step: z (B,H,W,latent) bf16 and act (B,actions) f32 ->
// out (B,H,W,latent_pad) bf16 latents in {0, 1}.  h1..h4 are caller-allocated
// (B,H,W,hidden) bf16 scratch; h5 reuses h3's buffer.  Weights are the
// (9, Cin, Cout) bf16 stacks of pack_transition_weights, biases f32.
// Requires hidden in {48, 64, 80, 128} (the shipped teacher and students),
// latent_pad == 16 and cin1 a multiple of 32 that holds latent + actions.
// Returns the first launch error, or 0.
extern "C" int scm_transition_step(
    const void* z, const void* act,
    const void* w1, const void* w2, const void* w3, const void* w4,
    const void* w5, const void* w6,
    const void* b1, const void* b2, const void* b3, const void* b4,
    const void* b5, const void* b6,
    void* h1, void* h2, void* h3, void* h4, void* out,
    int batch, int height, int width, int latent, int actions, int cin1,
    int hidden, int latent_pad, int sample, unsigned long long seed,
    void* stream_handle) {
  if (latent_pad != 16 || cin1 % BK != 0 || latent + actions > cin1 ||
      batch < 1 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  const void* w[6] = {w1, w2, w3, w4, w5, w6};
  const void* b[6] = {b1, b2, b3, b4, b5, b6};
  ConvArgs a{};
  a.batch = batch; a.height = height; a.width = width; a.seed = seed;
#define SCM_STEP(HID)                                                       \
  case HID:                                                                 \
    return (int)step<HID>(a, z, act, w, b, h1, h2, h3, h4, out, latent,     \
                          actions, cin1, latent_pad, sample, stream);
  switch (hidden) {
    SCM_STEP(48) SCM_STEP(64) SCM_STEP(80) SCM_STEP(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCM_STEP
}
