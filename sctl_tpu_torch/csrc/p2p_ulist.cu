// Per-box U-list P2P.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_ulist` (pl.pallas_call at
// :496, body `_ulist_kernel_body`).  For box g, target slot t < T:
//   out[g, t, :] = sum_{s < S} K(xt[g, :, t] - xs[g, :, s]) f[g, :, s]
// over the box's gathered source slots (zero density in padding, so
// padded slots add nothing); r2 = 0 is masked; unscaled.  The kernel
// formula is a template parameter (ukernels.cuh): the six kernels with
// a tree path (the uniform KIFMM's S2M, L2T and near field below the
// shared-surface and slab kernels' widths) and the BIE's Stokes3D-DxU
// and -FSxU; the double layers read the source normals.
//
// Bound on the H100: the bytes of the real slots.  The BIE far field's
// U list (G = 3,536 leaves, T = 64, S = 10,752 slots, Stokes DxU) is
// about 2.4e9 padded pair slots per operator apply for 4.2e7 needed
// pairs; counted on the needed pairs and the real slots' bytes, the
// bytes bound it (PERF.md §6), and the padding is what the kernel
// spends its time on.
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
#include "ukernels.cuh"

namespace {

constexpr int kTB = 64;           // targets per block
constexpr int kThreads = 256;
constexpr int kSplit = kThreads / kTB;
constexpr int kTS = 256;          // source slots per shared tile

template <int KER>
__global__ void __launch_bounds__(kThreads)
p2p_ulist_kernel(const float* __restrict__ xt, const float* __restrict__ xs,
                 const float* __restrict__ ns, const float* __restrict__ f,
                 float* __restrict__ out, int T, int S) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1;
  constexpr bool kNormals = D::nrm;
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
      float fv[K0], nv[3];
#pragma unroll
      for (int c = 0; c < K0; ++c) fv[c] = sf[c][i];
      if constexpr (kNormals) {
#pragma unroll
        for (int c = 0; c < 3; ++c) nv[c] = sn[c][i];
      }
      sctl::uker_acc<KER>(x - sx[0][i], y - sx[1][i], z - sx[2][i], fv, nv,
                          acc);
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
struct Launch {
  static int run(const float* xt, const float* xs, const float* ns,
                 const float* f, float* out, int G, int T, int S,
                 cudaStream_t stream) {
    dim3 grid(G, (T + kTB - 1) / kTB);
    p2p_ulist_kernel<KER><<<grid, kThreads, 0, stream>>>(xt, xs, ns, f, out,
                                                         T, S);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// xt (G, 3, T), xs (G, 3, S), ns (G, 3, S) (double layers only, else
// null), f (G, k0, S), out (G, T, k1); float32.  ker: the formula index
// of ukernels.cuh, one of the six kernels with a tree path.
SCTL_API int sctl_p2p_ulist(const float* xt, const float* xs,
                            const float* ns, const float* f, float* out,
                            int ker, int G, int T, int S,
                            cudaStream_t stream) {
  using namespace sctl;
  if (G == 0) return 0;
  return dispatch_formula<Launch, kLapFxU, kLapDxU, kLapFxdU, kStkFxU,
                          kStkDxU, kStkFSxU>(ker, xt, xs, ns, f, out, G, T,
                                             S, stream);
}
