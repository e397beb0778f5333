// Per-box U-list P2P.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_ulist` (pl.pallas_call at
// :496, body `_ulist_kernel_body`).  For box g, target slot t < T:
//   out[g, t, :] = sum_{s < S} K(xt[g, :, t] - xs[g, :, s]) f[g, :, s]
// over the box's gathered source slots (zero density in padding, so
// padded slots add nothing); r2 = 0 is masked; unscaled.  The kernel
// formula is a template parameter: Laplace3D-FxU, Stokes3D-DxU (reads
// source normals) and Stokes3D-FSxU.
//
// Bound on the H100: the f32 operations of the pairs.  The BIE far
// field's U list (G = 3,536 leaves, T = 64, S = 10,752 slots, Stokes
// DxU) is about 2.4e9 padded pair slots per operator apply, each about
// 30 f32 flops and one rsqrt: the FMA pipes (67 TFLOP/s) bound it
// before the special-function units (16 rsqrt per SM per clock) or the
// bytes (10 floats per source slot, read once per 64 targets).
//
// Design: one block of 256 threads per (box, 64 targets).  The block
// stages 256 source slots at a time in shared memory (coordinates,
// normals, densities); the 4 groups of 64 threads split each tile
// between them, so every thread of a warp reads the same slot (a
// shared-memory broadcast) for its own target, with the sums in f32
// registers.  The 4 partial sums of a target meet in shared memory at
// the end.  Per-pair differences, not moment expansions, keep float32
// exact to the pair's scale.
#include "common.cuh"

namespace {

constexpr int kTB = 64;           // targets per block
constexpr int kThreads = 256;
constexpr int kSplit = kThreads / kTB;
constexpr int kTS = 256;          // source slots per shared tile

enum { kLapFxU = 0, kStkDxU = 1, kStkFSxU = 2 };

template <int KER> struct Dims;
template <> struct Dims<kLapFxU> { static constexpr int k0 = 1, k1 = 1; };
template <> struct Dims<kStkDxU> { static constexpr int k0 = 3, k1 = 3; };
template <> struct Dims<kStkFSxU> { static constexpr int k0 = 4, k1 = 3; };

template <int KER>
__global__ void __launch_bounds__(kThreads)
p2p_ulist_kernel(const float* __restrict__ xt, const float* __restrict__ xs,
                 const float* __restrict__ ns, const float* __restrict__ f,
                 float* __restrict__ out, int T, int S) {
  constexpr int K0 = Dims<KER>::k0, K1 = Dims<KER>::k1;
  constexpr bool kNormals = KER == kStkDxU;
  __shared__ float sx[3][kTS];
  __shared__ float sn[kNormals ? 3 : 1][kTS];
  __shared__ float sf[K0][kTS];
  __shared__ float red[kSplit - 1][K1][kTB];

  const long g = blockIdx.x;
  const int tl = threadIdx.x % kTB, part = threadIdx.x / kTB;
  const int t = blockIdx.y * kTB + tl;
  const float* xtg = xt + g * 3 * T;
  const float* xsg = xs + g * 3 * S;
  const float* nsg = kNormals ? ns + g * 3 * S : nullptr;
  const float* fg = f + g * K0 * S;
  const bool live = t < T;
  const float x = live ? xtg[t] : 0.f;
  const float y = live ? xtg[T + t] : 0.f;
  const float z = live ? xtg[2 * T + t] : 0.f;
  float acc[K1];
#pragma unroll
  for (int j = 0; j < K1; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTS) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTS; i += kThreads) {
      const int s = s0 + i;
      const bool in = s < S;
#pragma unroll
      for (int c = 0; c < 3; ++c) sx[c][i] = in ? xsg[c * S + s] : 0.f;
      if constexpr (kNormals) {
#pragma unroll
        for (int c = 0; c < 3; ++c) sn[c][i] = in ? nsg[c * S + s] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < K0; ++c) sf[c][i] = in ? fg[c * S + s] : 0.f;
    }
    __syncthreads();
    for (int i = part; i < kTS; i += kSplit) {
      const float dx = x - sx[0][i], dy = y - sx[1][i], dz = z - sx[2][i];
      const float rinv = rinv_masked(dx * dx + dy * dy + dz * dz);
      if constexpr (KER == kLapFxU) {
        acc[0] += sf[0][i] * rinv;
      } else {
        const float rinv2 = rinv * rinv;
        const float rdotf = dx * sf[0][i] + dy * sf[1][i] + dz * sf[2][i];
        float w;
        if constexpr (KER == kStkDxU) {
          const float rdotn = dx * sn[0][i] + dy * sn[1][i] + dz * sn[2][i];
          w = rdotf * rdotn * (rinv2 * rinv2 * rinv);
        } else {
          const float rinv3 = rinv2 * rinv;
          w = (rdotf + sf[3][i]) * rinv3;
          acc[0] += sf[0][i] * rinv;
          acc[1] += sf[1][i] * rinv;
          acc[2] += sf[2][i] * rinv;
        }
        acc[0] += dx * w;
        acc[1] += dy * w;
        acc[2] += dz * w;
      }
    }
  }
  if (part > 0) {
#pragma unroll
    for (int j = 0; j < K1; ++j) red[part - 1][j][tl] = acc[j];
  }
  __syncthreads();
  if (part == 0 && live) {
#pragma unroll
    for (int j = 0; j < K1; ++j) {
      float v = acc[j];
#pragma unroll
      for (int p = 0; p < kSplit - 1; ++p) v += red[p][j][tl];
      out[(g * T + t) * K1 + j] = v;
    }
  }
}

template <int KER>
int launch(const float* xt, const float* xs, const float* ns, const float* f,
           float* out, int G, int T, int S, cudaStream_t stream) {
  dim3 grid(G, (T + kTB - 1) / kTB);
  p2p_ulist_kernel<KER><<<grid, kThreads, 0, stream>>>(xt, xs, ns, f, out,
                                                       T, S);
  return (int)cudaGetLastError();
}

}  // namespace

// xt (G, 3, T), xs (G, 3, S), ns (G, 3, S) (Stokes DxU only, else
// null), f (G, k0, S), out (G, T, k1); float32.  ker: 0 Laplace3D-FxU,
// 1 Stokes3D-DxU, 2 Stokes3D-FSxU.
SCTL_API int sctl_p2p_ulist(const float* xt, const float* xs,
                            const float* ns, const float* f, float* out,
                            int ker, int G, int T, int S,
                            cudaStream_t stream) {
  if (G == 0) return 0;
  switch (ker) {
    case kLapFxU: return launch<kLapFxU>(xt, xs, ns, f, out, G, T, S, stream);
    case kStkDxU: return launch<kStkDxU>(xt, xs, ns, f, out, G, T, S, stream);
    case kStkFSxU:
      return launch<kStkFSxU>(xt, xs, ns, f, out, G, T, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
