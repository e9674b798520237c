// One conv of the int8 (w8a8) transition step, for sm_90a.  Six launches
// make one step; ops/kernels/int8_transition.py sequences them.
//
// Replaces both Pallas int8 transitions, which compute the same six-conv
// circular w8a8 step with all activations resident in VMEM:
//   scmgan_tpu/ops/pallas/quantized_transition.py, quantized_transition
//     (pallas_call at :199), epilogue (pa*sa + pb*sb) + b on conv5/conv6;
//   scmgan_tpu/ops/pallas/int8_kernel.py, int8_fused_transition
//     (pallas_call at :201), epilogue (pa*sa + b) + pb*sb on conv5/conv6;
// and serves models/quantized.py::transition_int8(_v2), whose conv5/conv6
// weights are quantized jointly (one scale, acc*s + b).
//
// What bounds it on the H100: operations.  One step is 2 * 9 * (21 h + 5 h^2
// + 32 h) operations a pixel (h = hidden, 5 actions, latent 16): at B = 100,
// 64x64, that is 6.54e11 at h = 128 and 1.04e11 at h = 48, 0.331 ms and
// 0.052 ms at the card's 1,979 TOP/s int8 peak.  The latent bytes (int8 in
// and out) and the weights are far below that.
//
// Design, modelled on fused_transition.cu: one implicit-GEMM kernel per conv.
// A block computes 128 output pixels x all output channels with int8 tensor
// core MMAs (WMMA 16x16x16, signed char, int32 accumulation).  K runs over
// (tap, channel) flattened in 16-channel chunks, 64 rows a stage, so a tap's
// channels need not fill a stage (hidden 48 and 80); each K segment is
// zero-padded to whole stages.  Stages are double-buffered in shared memory,
// the next one's global loads in flight during the MMAs.  Both operands sit
// in shared memory chunk by chunk ([chunk][row][16 bytes]), so every WMMA
// pointer is 32-byte aligned.  The circular wrap is index arithmetic in the
// loads; the U-Net skip concat of conv5/conv6 is a second K segment read from
// a second tensor.  conv1 reads only the latents; its one-hot action half
// arrives as a per-sample int32 bias (the conv of a spatially constant map is
// a sum over taps), so its int32 sums equal those of the full conv.
//
// Numerics, held bit for bit to int8_transition_plain:
//   * int32 sums are exact whatever their order;
//   * "joint" order: y = acc * s + b; "split" orders keep the two K
//     segments' sums apart (the first one parked in shared memory when the
//     second begins), y = (pa * sa + pb * sb) + b or (pa * sa + b) + pb * sb;
//   * every product and sum is __fmul_rn / __fadd_rn, so nvcc cannot contract
//     them into an FMA (the references round after the multiply);
//   * leaky-ReLU, then round half to even (__float2int_rn, as jnp.round and
//     torch.round) of y * requant, clamped to +-127;
//   * heads: logits > 0 (transition_int8_v2), sigmoid > 0.5 (the others), or
//     u < sigmoid with u from the Philox stream of common.cuh.
//
// Left for later: wgmma with s8 operands and TMA loads (this uses the older
// mma.sync path through WMMA), and fusing the six launches so activations
// stay on chip.
//
// Interface: plain C, no PyTorch headers (built by nvcc in seconds and loaded
// with ctypes); every function returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
using scm::wrap;

namespace {

constexpr int BM = 128;                  // output pixels per block
constexpr int CHUNK = 16;                // channels (bytes) per K chunk
constexpr int CHUNKS = 4;                // chunks per stage
constexpr int BK = CHUNK * CHUNKS;       // K rows per stage
constexpr int THREADS = 256;             // 8 warps
// Bytes per A chunk plane: 128 rows of 16 bytes, plus a 32-byte skew so the
// two chunks a thread stores fall on different banks.
constexpr int A_PLANE = BM * CHUNK + 32;

enum Order { JOINT = 0, SUM_FIRST = 1, BIAS_FIRST = 2 };
enum Head { REQUANT = 0, LOGIT = 1, SIGMOID = 2, SAMPLE = 3 };

struct ConvArgs {
  const signed char* in0;     // NHWC, c0 channels
  const signed char* in1;     // NHWC, c1 channels (second K segment), or null
  const signed char* w;       // stages x [CHUNKS][cout][CHUNK], see pack_kernel_weights
  const float* scale0;        // (cout): the joint scale, or segment 0's
  const float* scale1;        // (cout): segment 1's (split orders)
  const float* bias;          // (cout)
  const int* extra;           // (batch, cout) int32 added to the sums, or null
  const float* requant;       // (cout) for REQUANT, else null
  signed char* out;           // NHWC, cout channels
  int batch, height, width;
  int c0, c1, cout;
  int stages0, stages1;       // K stages of each segment
  int order, head;
  unsigned long long seed;    // sample head
};

constexpr int smem_bytes(int bn, bool split) {
  return 2 * CHUNKS * A_PLANE + 2 * BK * bn + (THREADS / 32) * 256 * 4 +
         (split ? BM * bn * 4 : 0);
}

__device__ __forceinline__ float sigmoid(float y) {
  return 1.f / (1.f + expf(-y));
}

// Two blocks per SM, as in fused_transition.cu.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_s8(const ConvArgs p) {
  constexpr int WARPS_N = (BN >= 64 && BN % 32 == 0) ? 2 : 1;
  constexpr int WARPS_M = 8 / WARPS_N;
  constexpr int WM = BM / WARPS_M;          // rows per warp: 32 or 16
  constexpr int WN = BN / WARPS_N;          // cols per warp: a multiple of 16
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int B_VECS = BK * BN / 16;      // 16-byte vectors per B stage
  constexpr int B_PER_THREAD = (B_VECS + THREADS - 1) / THREADS;

  extern __shared__ __align__(128) unsigned char smem[];
  signed char* As = reinterpret_cast<signed char*>(smem);   // [2][CHUNKS][A_PLANE]
  signed char* Bs = As + 2 * CHUNKS * A_PLANE;               // [2][CHUNKS][BN][CHUNK]
  int* stage = reinterpret_cast<int*>(Bs + 2 * BK * BN);     // [8 warps][16 x 16]
  int* part = stage + (THREADS / 32) * 256;                  // [BM][BN], split only

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = p.height, W = p.width, hw = H * W;
  const long long M = (long long)p.batch * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int stages = p.stages0 + p.stages1;
  const bool split = p.order != JOINT;

  // A stage: 128 pixels x 4 chunks; thread t loads chunks 2 (t % 2) and
  // 2 (t % 2) + 1 of pixel t / 2.  Each chunk is 16 channels of one tap.
  const int a_row = tid / 2, a_chunk = (tid % 2) * 2;
  const long long a_gm = m0 + a_row;
  const bool a_ok = a_gm < M;
  int a_b = 0, a_y = 0, a_x = 0;
  if (a_ok) {
    a_b = (int)(a_gm / hw);
    const int r = (int)(a_gm % hw);
    a_y = r / W;
    a_x = r % W;
  }

  uint4 a_reg[2];
  uint4 b_reg[B_PER_THREAD];

  auto load_stage = [&](int s) {
    const bool seg1 = s >= p.stages0;
    const int c = seg1 ? p.c1 : p.c0;
    const signed char* src = seg1 ? p.in1 : p.in0;
    const int per_tap = c / CHUNK;
    const int v0 = (seg1 ? s - p.stages0 : s) * CHUNKS + a_chunk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a_reg[i] = make_uint4(0, 0, 0, 0);
      const int v = v0 + i;
      if (!a_ok || v >= 9 * per_tap) continue;   // the segment's zero padding
      const int tap = v / per_tap, ch = (v - tap * per_tap) * CHUNK;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const long long pix =
          ((long long)a_b * H + wrap(a_y + dy, H)) * W + wrap(a_x + dx, W);
      a_reg[i] = *reinterpret_cast<const uint4*>(src + pix * c + ch);
    }
    const signed char* wk = p.w + (size_t)s * BK * BN;
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      if (v < B_VECS) b_reg[i] = *reinterpret_cast<const uint4*>(wk + (size_t)v * 16);
    }
  };

  auto store_stage = [&](int buf) {
    signed char* a = As + buf * CHUNKS * A_PLANE;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(a + (a_chunk + i) * A_PLANE + a_row * CHUNK) = a_reg[i];
    signed char* b = Bs + buf * BK * BN;
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      if (v < B_VECS) *reinterpret_cast<uint4*>(b + v * 16) = b_reg[i];
    }
  };

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  load_stage(0);
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    // Safe to overwrite buf: every warp passed the previous barrier, so it
    // finished the MMAs that read buf two stages ago.
    store_stage(buf);
    __syncthreads();
    if (s + 1 < stages) load_stage(s + 1);
    if (split && s == p.stages0) {
      // The first segment's sums are complete: park them (each warp its own
      // tiles) and start the second segment from zero.
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::store_matrix_sync(part + (wm * WM + i * 16) * BN + wn * WN + j * 16,
                                  acc[i][j], BN, wmma::mem_row_major);
          wmma::fill_fragment(acc[i][j], 0);
        }
    }
    const signed char* a = As + buf * CHUNKS * A_PLANE;
    const signed char* b = Bs + buf * BK * BN;
#pragma unroll
    for (int kc = 0; kc < CHUNKS; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a + kc * A_PLANE + (wm * WM + i * 16) * CHUNK, CHUNK);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b + (kc * BN + wn * WN + j * 16) * CHUNK, CHUNK);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }

  // Epilogue: each warp stages one 16x16 int32 tile at a time; lane l
  // finishes 8 consecutive channels of row l / 2 and stores them as one
  // 8-byte write.
  int* st = stage + warp * 256;
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * WM + i * 16 + r;
      const long long gm = m0 + row;
      const int col = wn * WN + j * 16 + c8;
      if (gm < M) {
        const int sample = (int)(gm / hw);
        __align__(8) signed char o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = col + e;
          int sum = st[r * 16 + c8 + e];
          if (p.extra) sum += p.extra[(size_t)sample * p.cout + n];
          float y;
          if (!split) {
            y = __fadd_rn(__fmul_rn(__int2float_rn(sum), p.scale0[n]), p.bias[n]);
          } else {
            const float ya = __fmul_rn(__int2float_rn(part[row * BN + n]), p.scale0[n]);
            const float yb = __fmul_rn(__int2float_rn(sum), p.scale1[n]);
            y = p.order == SUM_FIRST ? __fadd_rn(__fadd_rn(ya, yb), p.bias[n])
                                     : __fadd_rn(__fadd_rn(ya, p.bias[n]), yb);
          }
          int q;
          if (p.head == REQUANT) {
            const float l = y >= 0.f ? y : __fmul_rn(0.01f, y);
            q = min(127, max(-127, __float2int_rn(__fmul_rn(l, p.requant[n]))));
          } else if (p.head == LOGIT) {
            q = y > 0.f;
          } else if (p.head == SIGMOID) {
            q = sigmoid(y) > 0.5f;
          } else {
            q = scm::philox_uniform((unsigned long long)gm * p.cout + n, p.seed) <
                sigmoid(y);
          }
          o[e] = (signed char)q;
        }
        *reinterpret_cast<uint2*>(p.out + gm * p.cout + col) =
            *reinterpret_cast<const uint2*>(o);
      }
      __syncwarp();
    }
  }
}

template <int BN>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be asked for; ask once for the
  // split case, the larger.
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_s8<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(BN, true));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long M = (long long)a.batch * a.height * a.width;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  conv3x3_s8<BN><<<blocks, THREADS, smem_bytes(BN, a.order != JOINT), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One circular 3x3 int8 conv with its epilogue.  in0 (B,H,W,c0) and, for a
// two-segment K, in1 (B,H,W,c1) int8; w the kernel layout of
// int8_transition.py::pack_kernel_weights; out (B,H,W,cout) int8.
// order: 0 joint, 1 (pa*sa + pb*sb) + b, 2 (pa*sa + b) + pb*sb (1 and 2 need
// in1 and scale1).  head: 0 leaky-ReLU + requant (needs requant), 1 logits > 0,
// 2 sigmoid > 0.5, 3 Philox sample keyed by seed.  extra: (B, cout) int32
// added to the sums (joint only), or null.  Requires c0, c1 multiples of 16
// and cout in {16, 48, 64, 80, 128}.  Returns the launch error, or 0.
extern "C" int scm_int8_conv(
    const void* in0, int c0, const void* in1, int c1, const void* w,
    const void* scale0, const void* scale1, const void* bias,
    const void* extra, const void* requant, void* out,
    int batch, int height, int width, int cout, int order, int head,
    unsigned long long seed, void* stream_handle) {
  const bool split = order != JOINT;
  if (c0 < CHUNK || c0 % CHUNK || c1 < 0 || c1 % CHUNK ||
      (c1 > 0) != (in1 != nullptr) || order < JOINT || order > BIAS_FIRST ||
      (split && (c1 == 0 || scale1 == nullptr || extra != nullptr)) ||
      head < REQUANT || head > SAMPLE || (head == REQUANT) != (requant != nullptr) ||
      batch < 1 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.in0 = (const signed char*)in0; a.in1 = (const signed char*)in1;
  a.w = (const signed char*)w;
  a.scale0 = (const float*)scale0; a.scale1 = (const float*)scale1;
  a.bias = (const float*)bias; a.extra = (const int*)extra;
  a.requant = (const float*)requant; a.out = (signed char*)out;
  a.batch = batch; a.height = height; a.width = width;
  a.c0 = c0; a.c1 = c1; a.cout = cout;
  a.stages0 = (9 * c0 + BK - 1) / BK;
  a.stages1 = (9 * c1 + BK - 1) / BK;
  a.order = order; a.head = head; a.seed = seed;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  switch (cout) {
    case 16: return (int)launch<16>(a, stream);
    case 48: return (int)launch<48>(a, stream);
    case 64: return (int)launch<64>(a, stream);
    case 80: return (int)launch<80>(a, stream);
    case 128: return (int)launch<128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
