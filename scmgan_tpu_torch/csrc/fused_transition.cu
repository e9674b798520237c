// One eval/sampling step of the world model's transition, for sm_90a: the
// host side of six launches of the conv kernel in transition_conv.cuh.
//
// Replaces: scmgan_tpu/ops/pallas/fused_transition.py, fused_transition
// (pallas_call at :214), which runs the whole step -- action broadcast, six
// circular 3x3 convs with the U-Net skip concats, leaky-ReLU, sigmoid and the
// threshold or Bernoulli head -- with all six 64x64x128 activations resident
// in a 100 MB VMEM window.
//
// What bounds it on the H100: operations.  One step is 6.5 GFLOP per image
// at hidden 128 (K = 9 * Cin up to 2304) against about 26 MB of bf16
// activations read and written per image over all six layers: 0.66 ms at
// B = 100 at the bf16 tensor-core peak, well above the bytes' time.  What
// held the first kernel (WMMA, 128-pixel blocks) at 13% of that was traffic
// and issue, not the MMAs: every activation byte crossed L2 -> SM once per
// tap (9x), every 128-pixel block streamed the whole weight matrix, loads
// went through registers with a block barrier every 32 channels, and legacy
// mma.sync ran at two blocks an SM with spilled registers.
//
// What the design does about it (details in transition_conv.cuh): a block
// owns 256 output pixels of whole image rows, copies their input rows once
// per 64-channel chunk and runs all 9 taps from that copy (A traffic
// (R+2)/R = 1.5x, not 9x); A goes to wgmma from registers via ldmatrix with
// per-lane wrapped addresses; the weights stream by TMA into an mbarrier
// ring from a producer warp, each tile reused by four m64 wgmmas; a
// persistent grid of one 3-warpgroup block an SM; the epilogue runs in
// registers and stores 16 bytes at a time.  Still unfused across layers:
// each activation goes to device memory and back through L2 (ROADMAP).
//
// Tensor maps are encoded with cuTensorMapEncodeTiled (tensor_map.cuh).
//
// Interface: plain C, no PyTorch headers (built by nvcc and loaded with
// ctypes); every function returns a cudaError_t as int.

#include <cuda.h>
#include <cuda_runtime.h>

#include "tensor_map.cuh"
#include "transition_conv.cuh"

using namespace scm_tr;

// Instantiated in transition_h{16,32,48,64,80,96,112,128}.cu (each with
// KANY 0 and 1) and transition_head.cu.
#define SCM_EXTERN(BN, HEAD, KANY)                                             \
  extern template cudaError_t scm_tr::launch_conv<BN, HEAD, KANY>(            \
      const ConvArgs&, const CUtensorMap&, cudaStream_t);
#define SCM_EXTERN_N(BN) SCM_EXTERN(BN, LRELU, 0) SCM_EXTERN(BN, LRELU, 1)
SCM_EXTERN_N(16)
SCM_EXTERN_N(32)
SCM_EXTERN_N(48)
SCM_EXTERN_N(64)
SCM_EXTERN_N(80)
SCM_EXTERN_N(96)
SCM_EXTERN_N(112)
SCM_EXTERN_N(128)
SCM_EXTERN(16, THRESHOLD, 1)
SCM_EXTERN(16, SAMPLE, 1)
#undef SCM_EXTERN_N
#undef SCM_EXTERN

namespace {

constexpr int MAX_TILE_N = 128;   // the widest instantiation
constexpr int HEAD_TILE_N = 16;   // the head's N tiles

int chunks(int c) { return (c + CHUNK - 1) / CHUNK; }

// Whether the KANY = 0 instantiation at tile width bn compiles every chunk
// size that a K segment of c channels cuts into (transition_conv.cuh,
// compiles_chunk): whole chunks and the tail.
bool fits(int bn, int c) {
  const int tail = c % CHUNK / 16;
  return (c < CHUNK || bn >= 64) && (tail <= 1 || tail == bn % 64 / 16);
}

// One N tile: the weight map over the layer's (chunk, tap, ldo, 64) layout,
// read as boxes of bn rows, and the launch of the instantiation for bn.
template <int HEAD, int KANY>
cudaError_t tile(const ConvArgs& a, const void* w, int bn, cudaStream_t stream) {
  CUtensorMap map;
  const cudaError_t e = scm::weight_map(&map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                        (chunks(a.c0) + chunks(a.c1)) * 9 * a.ldo, bn);
  if (e != cudaSuccess) return e;
  if constexpr (HEAD != LRELU) return launch_conv<HEAD_TILE_N, HEAD, 1>(a, map, stream);
  switch (bn) {
    case 16: return launch_conv<16, LRELU, KANY>(a, map, stream);
    case 32: return launch_conv<32, LRELU, KANY>(a, map, stream);
    case 48: return launch_conv<48, LRELU, KANY>(a, map, stream);
    case 64: return launch_conv<64, LRELU, KANY>(a, map, stream);
    case 80: return launch_conv<80, LRELU, KANY>(a, map, stream);
    case 96: return launch_conv<96, LRELU, KANY>(a, map, stream);
    case 112: return launch_conv<112, LRELU, KANY>(a, map, stream);
    case 128: return launch_conv<128, LRELU, KANY>(a, map, stream);
    default: return cudaErrorInvalidValue;
  }
}

// One conv of cout output channels: hidden layers as N tiles of 128 and the
// rest (144 = 128 + 16, 208 = 128 + 80), the head as N tiles of 16; each
// tile's launch reads the whole input again.
cudaError_t conv(ConvArgs a, const void* w, int cout, int head, cudaStream_t stream) {
  a.ldo = cout;
  const int step = head == LRELU ? MAX_TILE_N : HEAD_TILE_N;
  for (int n0 = 0; n0 < cout; n0 += step) {
    const int bn = cout - n0 < step ? cout - n0 : step;
    a.n_off = n0;
    cudaError_t e;
    if (head == THRESHOLD) e = tile<THRESHOLD, 1>(a, w, bn, stream);
    else if (head == SAMPLE) e = tile<SAMPLE, 1>(a, w, bn, stream);
    else if (fits(bn, a.c0) && fits(bn, a.c1)) e = tile<LRELU, 0>(a, w, bn, stream);
    else e = tile<LRELU, 1>(a, w, bn, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// One transition step: z (B,H,W,latent_pad) bf16 (latents zero-padded to a
// multiple of 16) and act (B,actions) f32 -> out (B,H,W,latent_pad) bf16
// latents in {0, 1}.  h1..h4 are caller-allocated (B,H,W,hidden) bf16
// scratch; h5 reuses h3's buffer.  k1..k6 are the kernel-layout weights of
// pack_transition_weights ((chunk, tap, cout, 64) bf16; conv1 over the
// latent_pad channels), wact conv1's action weights summed over taps
// ((actions, hidden) f32), biases f32.  hidden is the model's width rounded
// up to 16 (pack_transition_weights pads the operands with zero channels);
// any width, any latent, any action count.  tw, tws, rows, row_blocks,
// col_blocks are the tile plan of ops/kernels/fused_transition.py::tile_plan.
// Returns the first launch error, or 0.
extern "C" int scm_transition_step(
    const void* z, const void* act,
    const void* k1, const void* k2, const void* k3, const void* k4,
    const void* k5, const void* k6,
    const void* b1, const void* b2, const void* b3, const void* b4,
    const void* b5, const void* b6, const void* wact,
    void* h1, void* h2, void* h3, void* h4, void* out,
    int batch, int height, int width, int actions, int hidden,
    int latent_pad, int tw, int tws, int rows, int row_blocks, int col_blocks,
    int sample, unsigned long long seed, void* stream_handle) {
  if (hidden < 16 || hidden % 16 || latent_pad < 16 || latent_pad % 16 || actions < 0 ||
      batch < 1 || height < 1 || width < 1 || tw < 1 || tw > 64 || rows < 1 ||
      (long long)(rows + 2) * tws > A_SLOTS || rows * tw > TILE_M ||
      (long long)row_blocks * rows < height || (long long)col_blocks * tw < width)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  typedef const __nv_bfloat16* In;
  typedef __nv_bfloat16* Out;
  ConvArgs a{};
  a.batch = batch; a.height = height; a.width = width; a.actions = actions;
  a.tw = tw; a.tws = tws; a.rows = rows; a.row_blocks = row_blocks;
  a.col_blocks = col_blocks; a.seed = seed;
  cudaError_t e;

  // conv1: z -> h1; the one-hot action half is a per-sample bias
  a.in0 = (In)z; a.in1 = nullptr; a.c0 = latent_pad; a.c1 = 0;
  a.act = (const float*)act; a.wact = (const float*)wact;
  a.bias = (const float*)b1; a.out = (Out)h1;
  if ((e = conv(a, k1, hidden, LRELU, stream)) != cudaSuccess) return (int)e;

  a.act = nullptr; a.wact = nullptr; a.c0 = hidden;
  // conv2: h1 -> h2; conv3: h2 -> h3; conv4: h3 -> h4
  a.in0 = (In)h1; a.bias = (const float*)b2; a.out = (Out)h2;
  if ((e = conv(a, k2, hidden, LRELU, stream)) != cudaSuccess) return (int)e;
  a.in0 = (In)h2; a.bias = (const float*)b3; a.out = (Out)h3;
  if ((e = conv(a, k3, hidden, LRELU, stream)) != cudaSuccess) return (int)e;
  a.in0 = (In)h3; a.bias = (const float*)b4; a.out = (Out)h4;
  if ((e = conv(a, k4, hidden, LRELU, stream)) != cudaSuccess) return (int)e;

  // conv5: [h4 | h2] -> h5 (into h3's buffer)
  a.in0 = (In)h4; a.in1 = (In)h2; a.c1 = hidden; a.bias = (const float*)b5;
  a.out = (Out)h3;
  if ((e = conv(a, k5, hidden, LRELU, stream)) != cudaSuccess) return (int)e;

  // conv6: [h5 | h1] -> sigmoid -> threshold or sample
  a.in0 = (In)h3; a.in1 = (In)h1; a.bias = (const float*)b6; a.out = (Out)out;
  return (int)conv(a, k6, latent_pad, sample ? SAMPLE : THRESHOLD, stream);
}

// Dynamic shared memory a block of the conv kernel takes at N tile width bn
// (16: the head), or -1.
extern "C" int scm_transition_smem(int bn) {
  switch (bn) {
    case 16: return Layout<16>::ALLOC;
    case 32: return Layout<32>::ALLOC;
    case 48: return Layout<48>::ALLOC;
    case 64: return Layout<64>::ALLOC;
    case 80: return Layout<80>::ALLOC;
    case 96: return Layout<96>::ALLOC;
    case 112: return Layout<112>::ALLOC;
    case 128: return Layout<128>::ALLOC;
    default: return -1;
  }
}
