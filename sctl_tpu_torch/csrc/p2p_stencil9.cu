// Near-field P2P over the packed 9-column slab.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_stencil9`
// (pl.pallas_call at :425).  For target box (x, y, z) in raster order
// and its slot t:
//   out[x, y, z, t, :] = sum_{s < 3 SL} K(xt[x, y, z, :, t]
//                        - xs[x, y, :, z SL + s]) f[x, y, :, z SL + s]
// where slab entry z' of column (x, y) holds the 9 (dx, dy) neighbour
// columns' box (x+dx, y+dy, z'-1), so the 27-box neighbourhood is the
// one window [z SL, (z+3) SL).  Boundary zeros and slot padding are in
// the slab (zero density); r2 = 0 is masked.  Unscaled.  The formula is
// a template parameter (ukernels.cuh): the six kernels with a tree
// path; the double layers read the slab's normals.
//
// Bound on the H100: the pairs.  At 1e7 points, depth 6: n = 64,
// cap_t = 48, SL = 512: 64^3 * 48 * 1536 = 1.9e10 pair evaluations
// (about 1.0e10 of them real points), one rsqrt and the formula's f32
// operations each, 16 rsqrt per SM per clock; the slabs (2.2 GB for
// Laplace) are read once per 4 z-boxes.
//
// Design: one block per (column, 4 consecutive z boxes), one thread per
// target slot.  The block stages the union of its windows, (4+2) SL
// slots, in shared memory: float4 (x, y, z, f_0), then one plane per
// further density component and per normal component, so a slot holds
// exactly what its formula reads (ops/p2p.py `stencil9_fits` counts
// these bytes).  Each staged source serves up to 3 * 4 * cap_t
// targets, and each pair costs broadcast shared loads, the distance,
// one masked rsqrt and the formula into f32 register sums.
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kZ = 4;   // z boxes per block

// float planes beyond the float4 (x, y, z, f_0) of a slot
template <int KER>
constexpr int extra_planes() {
  return sctl::Dims<KER>::k0 - 1 + (sctl::Dims<KER>::nrm ? 3 : 0);
}

template <int KER>
__global__ void p2p_stencil9_kernel(const float* __restrict__ xt,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ ns,
                                    const float* __restrict__ f,
                                    float* __restrict__ out, int n, int SL,
                                    int cap_t) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  extern __shared__ float4 win[];
  const int col = blockIdx.y;                // x * n + y
  const int z0 = blockIdx.x * kZ;
  const int nz = min(kZ, n - z0);
  const long slab = (long)(n + 2) * SL;
  const float* xc = xs + (long)col * 3 * slab;
  const float* nc = NN ? ns + (long)col * 3 * slab : nullptr;
  const float* fc = f + (long)col * K0 * slab;
  const long base = (long)z0 * SL;
  const int W = (nz + 2) * SL;
  const int Wmax = (kZ + 2) * SL;
  float* ext = reinterpret_cast<float*>(win + Wmax);   // (E, Wmax)
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long g = base + i;
    win[i] = make_float4(xc[g], xc[slab + g], xc[2 * slab + g], fc[g]);
#pragma unroll
    for (int c = 1; c < K0; ++c) ext[(c - 1) * Wmax + i] = fc[c * slab + g];
#pragma unroll
    for (int c = 0; c < NN; ++c)
      ext[(K0 - 1 + c) * Wmax + i] = nc[c * slab + g];
  }
  __syncthreads();
  const int zl = threadIdx.x / cap_t, t = threadIdx.x - zl * cap_t;
  if (zl >= nz) return;
  const long box = (long)col * n + z0 + zl;
  const float* xb = xt + box * 3 * cap_t;
  const float x = xb[t], y = xb[cap_t + t], z = xb[2 * cap_t + t];
  const int w0 = zl * SL;
  float acc[K1];
#pragma unroll
  for (int j = 0; j < K1; ++j) acc[j] = 0.f;
  for (int s = w0; s < w0 + 3 * SL; ++s) {
    const float4 q = win[s];
    float fv[K0], nv[3];
    fv[0] = q.w;
#pragma unroll
    for (int c = 1; c < K0; ++c) fv[c] = ext[(c - 1) * Wmax + s];
#pragma unroll
    for (int c = 0; c < NN; ++c) nv[c] = ext[(K0 - 1 + c) * Wmax + s];
    sctl::uker_acc<KER>(x - q.x, y - q.y, z - q.z, fv, nv, acc);
  }
  float* o = out + (box * cap_t + t) * K1;
#pragma unroll
  for (int j = 0; j < K1; ++j) o[j] = acc[j];
}

template <int KER>
struct Launch {
  static int run(const float* xt, const float* xs, const float* ns,
                 const float* f, float* out, int n, int SL, int cap_t,
                 cudaStream_t stream) {
    const size_t smem = (sizeof(float4) + sizeof(float) * extra_planes<KER>())
                        * (kZ + 2) * SL;
    cudaError_t err = allow_smem(p2p_stencil9_kernel<KER>, smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = (kZ * cap_t + 31) / 32 * 32;
    dim3 grid((n + kZ - 1) / kZ, n * n);
    p2p_stencil9_kernel<KER><<<grid, threads, smem, stream>>>(
        xt, xs, ns, f, out, n, SL, cap_t);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// xt (n, n, n, 3, cap_t), xs (n, n, 3, (n+2)*SL), ns (n, n, 3,
// (n+2)*SL) (double layers only, else null), f (n, n, k0, (n+2)*SL),
// out (n, n, n, cap_t, k1); float32.  ker: the formula index of
// ukernels.cuh, one of the six kernels with a tree path.
SCTL_API int sctl_p2p_stencil9(const float* xt, const float* xs,
                               const float* ns, const float* f, float* out,
                               int ker, int n, int SL, int cap_t,
                               cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch, kLapFxU, kLapDxU, kLapFxdU, kStkFxU,
                          kStkDxU, kStkFSxU>(ker, xt, xs, ns, f, out, n, SL,
                                             cap_t, stream);
}
