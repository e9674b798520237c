// The int8 transition conv kernel at hidden width 96 (layers 1-5, joint and
// split orders), in its own translation unit so the parallel nvcc calls
// share the build.

#include "int8_conv.cuh"

template cudaError_t scm_i8::launch_conv<96, 0>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_i8::launch_conv<96, 1>(
    const scm_i8::ConvArgs&, const CUtensorMap&, cudaStream_t);
