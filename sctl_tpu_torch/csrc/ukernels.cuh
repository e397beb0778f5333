// The eight kernel formulas of the port, written once for every CUDA
// pair kernel (the counterpart of sctl_tpu_torch/ops/uker.py and of
// sctl_tpu/ops/uker.py).  With r = x_target - x_source, the masked
// 1/|r| (0 where r2 == 0), the source's densities f[k0] and normal
// n[3], `uker_acc` adds the pair's unscaled contribution to acc[k1]:
//
//   0 Laplace3D-FxU   u   += f rinv
//   1 Laplace3D-DxU   u   += f (r.n) rinv^3
//   2 Laplace3D-FxdU  u_i += f r_i rinv^3
//   3 Stokes3D-FxU    u_i += f_i rinv + r_i (r.f) rinv^3
//   4 Stokes3D-DxU    u_i += r_i (r.f)(r.n) rinv^5
//   5 Stokes3D-FxT    u_jk += (r.f) r_j r_k rinv^5        (k1 = 9)
//   6 Stokes3D-FSxU   u_i += f_i rinv + r_i (r.f + f_3) rinv^3
//   7 Stokes3D-FxUP   Stokes3D-FxU, and p += (r.f) rinv^3  (k1 = 4)
//
// The numbers are `FORMULA` of uker.py.  Every formula is templated on
// the scalar type, so float and double kernels share it.  LEAN selects
// the instruction-lean form of the kernels redesigned for Hopper's issue
// rate (p2p_stencil.cu, p2p_stencil9.cu, p2p_ulist.cu, p2p_direct.cu):
// the flush-to-zero rsqrt (`rinv_ftz`), and each product fused into the
// sum on its own (two FMAs, not a multiply, an FMA and an add).  In
// float the rsqrt drops the denormal fix-up the default rsqrtf carries
// (four instructions a pair); in double it is a MUFU seed and two Newton
// steps (eight instructions) in place of the library rsqrt's longer
// chain and special-case path.
#pragma once
#include <cuda_runtime.h>

namespace sctl {

enum Formula {
  kLapFxU = 0, kLapDxU = 1, kLapFxdU = 2, kStkFxU = 3, kStkDxU = 4,
  kStkFxT = 5, kStkFSxU = 6, kStkFxUP = 7
};

// k0 densities in, k1 values out, and whether the source's normal is read
template <int K0, int K1, bool NRM> struct DimsOf {
  static constexpr int k0 = K0, k1 = K1;
  static constexpr bool nrm = NRM;
};
template <int KER> struct Dims;
template <> struct Dims<kLapFxU> : DimsOf<1, 1, false> {};
template <> struct Dims<kLapDxU> : DimsOf<1, 1, true> {};
template <> struct Dims<kLapFxdU> : DimsOf<1, 3, false> {};
template <> struct Dims<kStkFxU> : DimsOf<3, 3, false> {};
template <> struct Dims<kStkDxU> : DimsOf<3, 3, true> {};
template <> struct Dims<kStkFxT> : DimsOf<3, 9, false> {};
template <> struct Dims<kStkFSxU> : DimsOf<4, 3, false> {};
template <> struct Dims<kStkFxUP> : DimsOf<3, 4, false> {};

// Masked reciprocal distance, the port of `_rinv_t`
// (sctl_tpu/ops/pallas_p2p.py:41-67).  float: rsqrtf, the MUFU
// approximation (about 2 ulp), which keeps every pair kernel within
// the f32 bars; double: CUDA's rsqrt, within 1 ulp (its documented
// bound; it is not correctly rounded).
__device__ __forceinline__ float rinv_of(float r2) {
  return r2 > 0.f ? rsqrtf(r2) : 0.f;
}
__device__ __forceinline__ double rinv_of(double r2) {
  return r2 > 0.0 ? rsqrt(r2) : 0.0;
}
// The lean form, float: rsqrt.approx.ftz (MUFU.RSQ alone) and one
// select.  A subnormal r2 (a pair closer than 1.1e-19) counts as
// coincident, 0.
__device__ __forceinline__ float rinv_ftz(float r2) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(r2));
  return r2 >= 1.17549435e-38f ? r : 0.f;
}
// The lean form, double: the seed rsqrt.approx.ftz.f64 (MUFU.RSQ64H)
// and two Newton steps y += y (1/2 - (r2/2) y^2) in fused arithmetic,
// each squaring the relative error, seven DP instructions: within a few
// ulp for any normal r2, far below float's normal range too (the card
// tests hold it to 4 ulp of 1/sqrt from r2 = 1e-50 up).  The mask is one
// integer compare on the high word and a select, off the DP pipe: r2
// (a sum of squares, never negative) of zero or subnormal (a pair
// closer than 1.5e-154) counts as coincident, 0.
__device__ __forceinline__ double rinv_ftz(double r2) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(r2));
  const double h = 0.5 * r2;
  y = fma(y, fma(-h * y, y, 0.5), y);
  y = fma(y, fma(-h * y, y, 0.5), y);
  return __double2hiint(r2) >= 0x00100000 ? y : 0.0;
}

// acc[k1] += K(r) f for one pair; n is read only by the double layers.
template <int KER, bool LEAN = false, typename T>
__device__ __forceinline__ void uker_acc(T dx, T dy, T dz, const T* f,
                                         const T* n, T* acc) {
  const T r2 = dx * dx + dy * dy + dz * dz;
  T rinv;
  if constexpr (LEAN) {
    rinv = rinv_ftz(r2);
  } else {
    rinv = rinv_of(r2);
  }
  if constexpr (KER == kLapFxU) {
    acc[0] += f[0] * rinv;
    return;
  } else {
    const T rinv2 = rinv * rinv;
    const T rinv3 = rinv2 * rinv;
    if constexpr (KER == kLapDxU) {
      acc[0] += f[0] * (dx * n[0] + dy * n[1] + dz * n[2]) * rinv3;
    } else if constexpr (KER == kLapFxdU) {
      const T w = f[0] * rinv3;
      acc[0] += dx * w;
      acc[1] += dy * w;
      acc[2] += dz * w;
    } else {
      const T rdotf = dx * f[0] + dy * f[1] + dz * f[2];
      if constexpr (KER == kStkDxU || KER == kStkFxT) {
        const T rinv5 = rinv3 * rinv2;
        if constexpr (KER == kStkDxU) {
          const T w = rdotf * (dx * n[0] + dy * n[1] + dz * n[2]) * rinv5;
          acc[0] += dx * w;
          acc[1] += dy * w;
          acc[2] += dz * w;
        } else {
          const T w = rdotf * rinv5;
          const T r[3] = {dx, dy, dz};
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const T wj = w * r[j];
#pragma unroll
            for (int k = 0; k < 3; ++k) acc[3 * j + k] += wj * r[k];
          }
        }
      } else {
        T w = rdotf * rinv3;
        if constexpr (KER == kStkFSxU) w += f[3] * rinv3;
        if constexpr (LEAN) {
          acc[0] += f[0] * rinv;
          acc[1] += f[1] * rinv;
          acc[2] += f[2] * rinv;
          acc[0] += dx * w;
          acc[1] += dy * w;
          acc[2] += dz * w;
        } else {
          acc[0] += f[0] * rinv + dx * w;
          acc[1] += f[1] * rinv + dy * w;
          acc[2] += f[2] * rinv + dz * w;
        }
        if constexpr (KER == kStkFxUP) acc[3] += rdotf * rinv3;
      }
    }
  }
}

}  // namespace sctl

// Instantiate F<KER>::run(args...) for the runtime formula index `ker`
// among the compile-time list KERS...; cudaErrorInvalidValue when `ker`
// is not in the list.
template <template <int> class F, int... KERS, typename... Args>
inline int dispatch_formula(int ker, Args... args) {
  int err = (int)cudaErrorInvalidValue;
  ((ker == KERS ? (err = F<KERS>::run(args...), true) : false) || ...);
  return err;
}
