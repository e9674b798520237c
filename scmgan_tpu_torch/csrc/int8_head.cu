// The int8 transition's head conv (conv6, 16 latent channels out, any hidden
// width in) with its logit, sigmoid and Philox-sampled heads, joint and
// split orders, in its own translation unit.

#include "int8_conv.cuh"

template cudaError_t scm_i8::launch_conv<16, 0>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<16, 1>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
