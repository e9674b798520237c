// The bf16 transition conv kernel at N tile width 32 (hidden layers), in its
// own translation unit so the parallel nvcc calls share the build: KANY = 0
// compiles the chunk sizes a layer 32 wide reads, KANY = 1 all of them (the
// N tiles of wider layers, conv1 at other latent widths).

#include "transition_conv.cuh"

template cudaError_t scm_tr::launch_conv<32, scm_tr::LRELU, 0>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_tr::launch_conv<32, scm_tr::LRELU, 1>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
