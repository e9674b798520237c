// The int8 transition conv kernel at N tile width 16, joint and split orders,
// in its own translation unit: the head (conv6, N tiles of 16 latent
// channels out) with its logit, sigmoid and Philox-sampled heads, the hidden
// layers at hidden 16 and the 16-wide N tiles of wider ones; every segment
// length is compiled in, GEN = 1 for inputs wider than 128 channels.

#include "int8_conv.cuh"

template cudaError_t scm_i8::launch_conv<16, 0, 0>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<16, 1, 0>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<16, 0, 1>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<16, 1, 1>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
