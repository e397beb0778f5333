// Near-field P2P over 9 shifted halo columns.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_stencil` (pl.pallas_call
// at :340).  Boxes in raster order; column (x, y) of the halo arrays
// holds its n boxes' cap source slots z-major between cap-wide zero
// margins (ops/p2p.py `to_halo`), so target box (x, y, z)'s neighbours
// in column (x+dx, y+dy) are the window [z cap, (z+3) cap).  For its
// target slot t:
//   out[x, y, z, t, :] = sum_{dx, dy in -1..1, column in the domain}
//       sum_{s in the window} K(xt[x, y, z, :, t] - xs[x+dx, y+dy, :, s])
//                             f[x+dx, y+dy, :, s]
// with r2 = 0 masked; slot padding and margins carry zero density.
// Unscaled.  The formula is a template parameter (ukernels.cuh): the six
// kernels with a tree path; the double layers read the normals.
//
// Bound on the H100: the pairs, one rsqrt each at 16 per SM per clock
// (the formula's f32 operations at 67 TFLOP/s bound only the Stokes
// double layer and FxT).  ParticleFMM(accuracy=8) at 1e7 uniform points
// (depth 5, cap 344, cap_t 328): 32^3 * 328 * 27 * 344 = 9.98e10 slot
// pairs, 23.9 ms; the pairs of real points, which the bound counts, are
// about three quarters of them.  The bytes (0.3 GB) take 0.1 ms.
//
// Design: one block per (target box, chunk of up to 512 target slots),
// one thread per target slot.  For each of the 9 neighbour columns that
// lie in the domain (the test is uniform over the block) the block
// streams the column's window, clipped to the boxes that exist, through
// shared memory in tiles of 512 slots: float4 (x, y, z, f_0) and one
// plane per further density and normal component.  Each staged slot
// serves every target of the block with broadcast shared loads, the
// distance, one masked rsqrt and the formula.  So, unlike
// p2p_stencil9.cu, whose block holds a whole (4 + 2) SL slab window,
// shared memory does not bound the widths: any (cap, cap_t) runs.  Each
// thread sums a tile's pairs into a fresh f32 register sum and adds
// that to its total: in p2p_direct.cu a single running f32 sum a thread
// reached 5.006e-6 of the maximum against a float64 sum (Stokes DxU),
// over its 5e-6 bar.
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kTile = 512;   // source slots staged at a time

template <int KER>
__global__ void p2p_stencil_kernel(const float* __restrict__ xt,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ ns,
                                   const float* __restrict__ f,
                                   float* __restrict__ out, int n, int cap,
                                   int cap_t) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  constexpr int E = K0 - 1 + NN;           // planes beyond the float4
  __shared__ float4 win[kTile];
  __shared__ float ext[E > 0 ? E : 1][kTile];
  const long box = blockIdx.x;             // (x n + y) n + z
  const int x = (int)(box / ((long)n * n)), y = (int)(box / n % n),
            z = (int)(box % n);
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = t < cap_t;
  const float* xb = xt + box * 3 * cap_t;
  const float px = live ? xb[t] : 0.f, py = live ? xb[cap_t + t] : 0.f,
              pz = live ? xb[2 * cap_t + t] : 0.f;
  const long L = (long)(n + 2) * cap;      // slots of a column
  // the window's boxes that exist: z-1 .. z+1 within [0, n), at column
  // positions one past their index (the first margin)
  const int s_lo = max(z - 1, 0) * cap + cap;
  const int s_hi = min(z + 1, n - 1) * cap + 2 * cap;
  float acc[K1];
#pragma unroll
  for (int j = 0; j < K1; ++j) acc[j] = 0.f;
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      const int cx = x + dx, cy = y + dy;
      if (cx < 0 || cx >= n || cy < 0 || cy >= n) continue;
      const long col = (long)cx * n + cy;
      const float* xc = xs + col * 3 * L;
      const float* fc = f + col * K0 * L;
      const float* nc = NN ? ns + col * 3 * L : nullptr;
      for (int s0 = s_lo; s0 < s_hi; s0 += kTile) {
        const int m = min(kTile, s_hi - s0);
        __syncthreads();                   // the last tile is consumed
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
          const long g = (long)s0 + i;
          win[i] = make_float4(xc[g], xc[L + g], xc[2 * L + g], fc[g]);
#pragma unroll
          for (int c = 1; c < K0; ++c) ext[c - 1][i] = fc[c * L + g];
#pragma unroll
          for (int c = 0; c < NN; ++c) ext[K0 - 1 + c][i] = nc[c * L + g];
        }
        __syncthreads();
        if (!live) continue;
        float part[K1];
#pragma unroll
        for (int j = 0; j < K1; ++j) part[j] = 0.f;
        for (int i = 0; i < m; ++i) {
          const float4 q = win[i];
          float fv[K0], nv[3];
          fv[0] = q.w;
#pragma unroll
          for (int c = 1; c < K0; ++c) fv[c] = ext[c - 1][i];
#pragma unroll
          for (int c = 0; c < NN; ++c) nv[c] = ext[K0 - 1 + c][i];
          sctl::uker_acc<KER>(px - q.x, py - q.y, pz - q.z, fv, nv, part);
        }
#pragma unroll
        for (int j = 0; j < K1; ++j) acc[j] += part[j];
      }
    }
  }
  if (!live) return;
  float* o = out + (box * cap_t + t) * K1;
#pragma unroll
  for (int j = 0; j < K1; ++j) o[j] = acc[j];
}

template <int KER>
struct Launch {
  static int run(const float* xt, const float* xs, const float* ns,
                 const float* f, float* out, int n, int cap, int cap_t,
                 cudaStream_t stream) {
    const int up = (cap_t + 31) / 32 * 32;
    const int threads = up < kTile ? up : kTile;
    dim3 grid(n * n * n, (cap_t + threads - 1) / threads);
    p2p_stencil_kernel<KER><<<grid, threads, 0, stream>>>(xt, xs, ns, f, out,
                                                          n, cap, cap_t);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// xt (n, n, n, 3, cap_t), xs (n, n, 3, (n+2) cap), ns (n, n, 3,
// (n+2) cap) (double layers only, else null), f (n, n, k0, (n+2) cap),
// out (n, n, n, cap_t, k1); float32.  ker: the formula index of
// ukernels.cuh, one of the six kernels with a tree path.
SCTL_API int sctl_p2p_stencil(const float* xt, const float* xs,
                              const float* ns, const float* f, float* out,
                              int ker, int n, int cap, int cap_t,
                              cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch, kLapFxU, kLapDxU, kLapFxdU, kStkFxU,
                          kStkDxU, kStkFSxU>(ker, xt, xs, ns, f, out, n, cap,
                                             cap_t, stream);
}
