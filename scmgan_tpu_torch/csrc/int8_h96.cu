// The int8 transition conv kernel at N tile width 96 (hidden layers, joint and
// split orders), in its own translation unit so the parallel nvcc calls
// share the build: GEN = 0 takes inputs of one K segment each, of the
// lengths a layer 96 wide reads; GEN = 1 any input (the N tiles of wider
// layers, their split K, conv1 at other latent widths).

#include "int8_conv.cuh"

template cudaError_t scm_i8::launch_conv<96, 0, 0>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<96, 1, 0>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<96, 0, 1>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<96, 1, 1>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
