// The bf16 transition conv kernel at hidden width 16 (layers 1-5), in its own
// translation unit so the parallel nvcc calls share the build.

#include "transition_conv.cuh"

template cudaError_t scm_tr::launch_conv<16, scm_tr::LRELU>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
