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

namespace sctl {

// A 16-byte shared-memory record of W values of Real: float4 (W = 4) in
// the float builds, double2 (W = 2) in the double builds, whose source
// records are therefore two records where float's are one.  No shared
// load is wider than 16 bytes, so a record is one load either way.
template <typename Real> struct Rec16;
template <> struct Rec16<float> {
  using T = float4;
  static constexpr int W = 4;
  static __device__ __forceinline__ T pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void unpack(const T& q, float* v) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <> struct Rec16<double> {
  using T = double2;
  static constexpr int W = 2;
  static __device__ __forceinline__ T pack(const double* v) {
    return make_double2(v[0], v[1]);
  }
  static __device__ __forceinline__ void unpack(const T& q, double* v) {
    v[0] = q.x;
    v[1] = q.y;
  }
};

// records of n values
template <typename Real>
__host__ __device__ constexpr int records_of(int n) {
  return (n + Rec16<Real>::W - 1) / Rec16<Real>::W;
}

}  // namespace sctl
