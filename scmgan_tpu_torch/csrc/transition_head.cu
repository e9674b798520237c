// The bf16 transition's head conv (conv6) with its threshold and
// Philox-sampled heads, in its own translation unit: N tiles of 16 latent
// channels, any input width.

#include "transition_conv.cuh"

template cudaError_t scm_tr::launch_conv<16, scm_tr::THRESHOLD, 1>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_tr::launch_conv<16, scm_tr::SAMPLE, 1>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
