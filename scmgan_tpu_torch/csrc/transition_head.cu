// The bf16 transition's head conv (conv6, 16 latent channels out) with its
// threshold and Philox-sampled heads, in its own translation unit.

#include "transition_conv.cuh"

template cudaError_t scm_tr::launch_conv<16, scm_tr::THRESHOLD>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
template cudaError_t scm_tr::launch_conv<16, scm_tr::SAMPLE>(
    const scm_tr::ConvArgs&, const CUtensorMap&, cudaStream_t);
