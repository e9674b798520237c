// One step of the int8 (w8a8) transition, for sm_90a: the host side of six
// launches of the conv kernel in int8_conv.cuh.
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
// What the design does about it (details in int8_conv.cuh): the bf16
// kernel's shape with s8 wgmma (k32): a block owns up to 256 output pixels
// of whole image rows and copies their input rows once per input tensor
// (one 128-byte slot a pixel holds all of a hidden layer's channels); all 9
// taps read that copy through ldmatrix; K runs over (tap, 16-channel unit)
// pairs so odd unit counts (hidden 16, 48, 80, 112) waste at most half a
// step per segment, and a width between multiples of 16 runs on zero
// channels up to the next one (pack_operands pads its operands); the
// weights stream by TMA into an mbarrier ring from a producer warp; the
// split orders keep both segments' sums in registers; the epilogue repeats
// the plain version's f32 roundings in registers.  Still unfused across
// layers: each activation goes to device memory and back through L2.
//
// Numerics, held bit for bit to int8_transition_plain:
//   * int32 sums are exact whatever their order;
//   * "joint" order: y = acc * s + b; "split" orders keep the two K
//     segments' sums apart, y = (pa * sa + pb * sb) + b or
//     (pa * sa + b) + pb * sb;
//   * every product and sum is __fmul_rn / __fadd_rn, so nvcc cannot contract
//     them into an FMA (the references round after the multiply);
//   * leaky-ReLU, then round half to even (__float2int_rn, as jnp.round and
//     torch.round) of y * requant, clamped to +-127;
//   * heads: logits > 0 (transition_int8_v2), sigmoid > 0.5 (the others), or
//     u < sigmoid with u from the Philox stream of common.cuh.
//
// Interface: plain C, no PyTorch headers (built by nvcc and loaded with
// ctypes); every function returns a cudaError_t as int.

#include <cuda.h>
#include <cuda_runtime.h>

#include "int8_conv.cuh"
#include "tensor_map.cuh"

using namespace scm_i8;

// Instantiated in int8_h{32,48,64,80,96,112,128}.cu and int8_head.cu (N =
// 16: the head, the hidden layers at hidden 16 and the 16-wide N tiles of
// wider ones), GEN 0 and 1 each.
#define SCM_EXTERN(BN, SPLIT, GEN)                                             \
  extern template cudaError_t scm_i8::launch_conv<BN, SPLIT, GEN>(            \
      const ConvArgs&, const CUtensorMap&, cudaStream_t);
#define SCM_EXTERN_N(BN)                                                       \
  SCM_EXTERN(BN, 0, 0) SCM_EXTERN(BN, 1, 0) SCM_EXTERN(BN, 0, 1) SCM_EXTERN(BN, 1, 1)
SCM_EXTERN_N(16)
SCM_EXTERN_N(32)
SCM_EXTERN_N(48)
SCM_EXTERN_N(64)
SCM_EXTERN_N(80)
SCM_EXTERN_N(96)
SCM_EXTERN_N(112)
SCM_EXTERN_N(128)
#undef SCM_EXTERN_N
#undef SCM_EXTERN

namespace {

constexpr int MAX_TILE_N = 128;   // the widest instantiation
constexpr int HEAD_TILE_N = 16;   // the head's N tiles

// A tile plan (ops/kernels/fused_transition.py::tile_plan).
struct Plan {
  int tw, tws, rows, row_blocks, col_blocks;
};

bool plan_ok(const Plan& p, int height, int width, int tile_m) {
  return p.tw >= 1 && p.tw <= 64 && p.rows >= 1 && p.rows * p.tw <= tile_m &&
         (long long)(p.rows + 2) * p.tws <= A_SLOTS && (p.tws == p.tw || p.tws == 66) &&
         (long long)p.row_blocks * p.rows >= height && (long long)p.col_blocks * p.tw >= width;
}

// Whether the GEN = 0 instantiation at tile width bn takes an input tensor
// of c channels (none: c = 0): one K segment, of a length it compiles
// (int8_conv.cuh, segment and conv3x3_s8).
bool fits(int bn, int split, int c) {
  const int u = c / UNIT;
  return u <= SEG_UNITS && (u == 0 || bn == 16 || u == bn / 16 || (u == 1 && !split));
}

// One N tile of width bn on its tile plan (256-pixel tiles, or 128 where a
// warpgroup holds one split tile): the weight map over the layer's (tile,
// ldo, 128) layout, read as boxes of bn rows, and the launch of the
// instantiation for bn.
template <int SPLIT, int GEN>
cudaError_t tile(ConvArgs a, const void* w, int bn, const Plan& p256, const Plan& p128,
                 cudaStream_t stream) {
  const Plan& pl = (SPLIT && bn >= 80) ? p128 : p256;
  a.tw = pl.tw; a.tws = pl.tws; a.rows = pl.rows;
  a.row_blocks = pl.row_blocks; a.col_blocks = pl.col_blocks;
  const int u0 = a.c0 / UNIT, u1 = a.c1 / UNIT;
  int ktiles = 0;
  for (int s = 0; s < seg_count(u0) + seg_count(u1); ++s) ktiles += seg_tiles(seg_of(s, u0, u1).u);
  CUtensorMap map;
  const cudaError_t e =
      scm::weight_map(&map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ktiles * a.ldo, bn);
  if (e != cudaSuccess) return e;
  switch (bn) {
    case 16: return launch_conv<16, SPLIT, GEN>(a, map, stream);
    case 32: return launch_conv<32, SPLIT, GEN>(a, map, stream);
    case 48: return launch_conv<48, SPLIT, GEN>(a, map, stream);
    case 64: return launch_conv<64, SPLIT, GEN>(a, map, stream);
    case 80: return launch_conv<80, SPLIT, GEN>(a, map, stream);
    case 96: return launch_conv<96, SPLIT, GEN>(a, map, stream);
    case 112: return launch_conv<112, SPLIT, GEN>(a, map, stream);
    case 128: return launch_conv<128, SPLIT, GEN>(a, map, stream);
    default: return cudaErrorInvalidValue;
  }
}

// One conv of cout output channels: hidden layers as N tiles of 128 and the
// rest, the head (a.head != REQUANT) as N tiles of 16; each tile's launch
// reads the whole input again.
cudaError_t conv(ConvArgs a, const void* w, int cout, int split, const Plan& p256,
                 const Plan& p128, cudaStream_t stream) {
  a.ldo = cout;
  const int step = a.head == REQUANT ? MAX_TILE_N : HEAD_TILE_N;
  for (int n0 = 0; n0 < cout; n0 += step) {
    const int bn = cout - n0 < step ? cout - n0 : step;
    a.n_off = n0;
    const bool gen = !(fits(bn, split, a.c0) && fits(bn, split, a.c1));
    cudaError_t e;
    if (split) e = gen ? tile<1, 1>(a, w, bn, p256, p128, stream)
                       : tile<1, 0>(a, w, bn, p256, p128, stream);
    else e = gen ? tile<0, 1>(a, w, bn, p256, p128, stream)
                 : tile<0, 0>(a, w, bn, p256, p128, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// One int8 transition step: z (B,H,W,latent_pad) int8 latents (zero-padded
// to a multiple of 16 channels) and act (B,actions) f32 one-hot actions ->
// out (B,H,W,latent_pad) int8 bits.  wact is conv1's action half summed
// over taps ((actions, hidden) int32).  h1..h4 are caller-allocated
// (B,H,W,hidden) int8 scratch; h5 reuses h3's buffer.  k1..k6 are the
// weights of pack_kernel_weights ((tiles, cout, 128) int8; conv1 over the
// latent_pad channels), s1..s6 the f32 dequant scales (conv5/conv6:
// the main tensor's; s5b, s6b the skip's under a split order, else null),
// b1..b6 the f32 biases, r1..r5 the f32 requant multipliers.  order: 0
// joint, 1 (pa*sa + pb*sb) + b, 2 (pa*sa + b) + pb*sb.  head: 1 logits > 0,
// 2 sigmoid > 0.5, 3 Philox sample keyed by seed.  (tw, tws, rows,
// row_blocks, col_blocks) is the 256-pixel tile plan of
// ops/kernels/fused_transition.py::tile_plan, the second five its 128-pixel
// plan.  hidden is the model's width rounded up to 16 (pack_operands pads
// its operands with zero channels); any width, any latent, any action
// count.  Returns the first launch error, or 0.
extern "C" int scm_int8_step(
    const void* z, const void* act, const void* wact,
    const void* k1, const void* k2, const void* k3, const void* k4,
    const void* k5, const void* k6,
    const void* s1, const void* s2, const void* s3, const void* s4,
    const void* s5, const void* s6, const void* s5b, const void* s6b,
    const void* b1, const void* b2, const void* b3, const void* b4,
    const void* b5, const void* b6,
    const void* r1, const void* r2, const void* r3, const void* r4, const void* r5,
    void* h1, void* h2, void* h3, void* h4, void* out,
    int batch, int height, int width, int hidden, int latent_pad, int actions, int order,
    int head, int tw, int tws, int rows, int row_blocks, int col_blocks,
    int tw2, int tws2, int rows2, int row_blocks2, int col_blocks2,
    unsigned long long seed, void* stream_handle) {
  const Plan p256{tw, tws, rows, row_blocks, col_blocks};
  const Plan p128{tw2, tws2, rows2, row_blocks2, col_blocks2};
  const int split = order != JOINT;
  if (batch < 1 || height < 1 || width < 1 || hidden < UNIT || hidden % UNIT ||
      latent_pad < UNIT || latent_pad % UNIT || actions < 0 || order < JOINT ||
      order > BIAS_FIRST || head < LOGIT || head > SAMPLE ||
      (split && (s5b == nullptr || s6b == nullptr)) ||
      !plan_ok(p256, height, width, 256) || !plan_ok(p128, height, width, 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  typedef const signed char* In;
  typedef signed char* Out;
  typedef const float* F;
  ConvArgs a{};
  a.batch = batch; a.height = height; a.width = width; a.actions = actions;
  a.seed = seed;
  cudaError_t e;

  // conv1: z -> h1; the one-hot action half is a per-sample int32 bias
  a.in0 = (In)z; a.in1 = nullptr; a.c0 = latent_pad; a.c1 = 0;
  a.act = (const float*)act; a.wact = (const int*)wact; a.order = JOINT; a.head = REQUANT;
  a.scale0 = (F)s1; a.scale1 = nullptr; a.bias = (F)b1; a.requant = (F)r1;
  a.out = (Out)h1;
  if ((e = conv(a, k1, hidden, 0, p256, p128, stream)) != cudaSuccess) return (int)e;

  a.act = nullptr; a.wact = nullptr; a.c0 = hidden;
  // conv2: h1 -> h2; conv3: h2 -> h3; conv4: h3 -> h4
  a.in0 = (In)h1; a.scale0 = (F)s2; a.bias = (F)b2; a.requant = (F)r2; a.out = (Out)h2;
  if ((e = conv(a, k2, hidden, 0, p256, p128, stream)) != cudaSuccess) return (int)e;
  a.in0 = (In)h2; a.scale0 = (F)s3; a.bias = (F)b3; a.requant = (F)r3; a.out = (Out)h3;
  if ((e = conv(a, k3, hidden, 0, p256, p128, stream)) != cudaSuccess) return (int)e;
  a.in0 = (In)h3; a.scale0 = (F)s4; a.bias = (F)b4; a.requant = (F)r4; a.out = (Out)h4;
  if ((e = conv(a, k4, hidden, 0, p256, p128, stream)) != cudaSuccess) return (int)e;

  // conv5: [h4 | h2] -> h5 (into h3's buffer), in the packing's order
  a.in0 = (In)h4; a.in1 = (In)h2; a.c1 = hidden; a.order = order;
  a.scale0 = (F)s5; a.scale1 = split ? (F)s5b : nullptr; a.bias = (F)b5; a.requant = (F)r5;
  a.out = (Out)h3;
  if ((e = conv(a, k5, hidden, split, p256, p128, stream)) != cudaSuccess) return (int)e;

  // conv6: [h5 | h1] -> logits -> the head's int8 bits
  a.in0 = (In)h3; a.in1 = (In)h1; a.scale0 = (F)s6; a.scale1 = split ? (F)s6b : nullptr;
  a.bias = (F)b6; a.requant = nullptr; a.head = head; a.out = (Out)out;
  return (int)conv(a, k6, latent_pad, split, p256, p128, stream);
}

// Dynamic shared memory a block of the int8 conv kernel takes at N tile
// width bn (16: the head), or -1.
extern "C" int scm_int8_smem(int bn) {
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
