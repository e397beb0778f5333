// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers; built by sctl_tpu_torch/ops/_build.py for sm_90a).
#pragma once
#include <cuda_runtime.h>

#define SCTL_API extern "C" __attribute__((visibility("default")))

// Masked reciprocal distance: 0 where r2 == 0 (coincident and padding
// pairs), the port of `_rinv_t` (sctl_tpu/ops/pallas_p2p.py:41-67).
// rsqrtf is the MUFU approximation (about 2 ulp), which keeps every
// pair kernel within the f32 bar against its plain version.
__device__ __forceinline__ float rinv_masked(float r2) {
  return r2 > 0.f ? rsqrtf(r2) : 0.f;
}

// Allow dynamic shared memory above the 48 KB default for `kernel`.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
