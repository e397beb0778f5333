// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers; built by sctl_tpu_torch/ops/_build.py for sm_90a).
#pragma once
#include <cuda_runtime.h>

#define SCTL_API extern "C" __attribute__((visibility("default")))

// Allow `bytes` of dynamic shared memory for `kernel` where they and
// its static shared memory pass the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
