// Per-box U-list P2P over compacted source lists, float and double.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_ulist` (pl.pallas_call at
// :496, body `_ulist_kernel_body`), which sums each box's targets over
// a padded slab of gathered source slots (zero density in padding).
// Here box g's sources are the run [srng[g, 0], srng[g, 1]) of one flat
// list: points and normals as (3, N) planes, densities as rows of f
// read through fidx (row fidx[j] for source j; null: row j), so the
// caller gathers nothing per call.  For a real target slot
// t < tcnt[g] (null: every slot):
//   out[g, t, :] = sum_{srng[g, 0] <= j < srng[g, 1]}
//                  K(xt[g, :, t] - xs[:, j]) f[fidx[j], :]
// with r2 = 0 masked; slots at or past tcnt[g] are written 0.  Unscaled.
// The padded slab's slots carry zero density, so leaving them out
// changes only the order of the sums.  The kernel formula is a
// template parameter (ukernels.cuh): the six kernels with a tree path
// (the BIE's Stokes3D-DxU, and the uniform KIFMM's S2M and L2T below
// the shared-surface kernels' widths); the double layers read the
// source normals.
//
// Bound on the H100: the bytes.  The BIE far field's U list (3,536
// leaves, about 10 targets and 840 sources each, Stokes DxU) has
// 4.17e7 pairs an apply: 0.002 ms of rsqrt, 0.005 ms of its f32
// operations, and 0.032 ms for its targets, outputs and sources read
// once (a source once in each list that holds it).  The padded slabs
// of the JAX layout (64 target and 10,752 source slots a leaf) were
// 2.4e9 pair slots and a 456 MB gather an apply.
//
// Design: one launch an apply, one block of 128 threads per (box,
// chunk of up to 64 targets).  Each thread holds 2 targets; the box's
// ng = ceil(nt / 2) target groups split the 128 threads, so 128 / ng
// threads share each group's sources (thread = group + ng * share).
// The block stages its sources 256 at a time in shared memory
// (coordinates, normals, densities through fidx); each thread sums its
// share of a tile into fresh partial sums and adds them to its
// totals; the formula is ukernels.cuh's lean form (flush-to-zero
// rsqrt, fused sums).  The shares of a group meet in shared memory by a
// halving tree in a fixed order: no atomics, so a launch repeats bit
// for bit.
// Per-pair differences in the target box's frame, not moment
// expansions, keep float32 exact to the pair's scale.
//
// The double build (the BIE's far field in float64 on the card) is the
// same kernel on Real = double: the lean double rsqrt (a MUFU seed and two
// Newton steps, ukernels.cuh), fresh partial sums a tile and the fixed
// halving tree as in float, so a launch repeats bit for bit.  Its pair
// loop is bound by the DP pipe (64 lanes a clock per SM, against 128 for
// float's issue), about 2x the bound of its operations at 34 TFLOP/s;
// chip_smoke.py reads its DP instructions a pair from the SASS.  Static
// shared memory doubles with the type: 24 KB a block for Stokes3D-DxU,
// under the 48 KB of a block without the opt-in.
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kR = 2;             // targets a thread
constexpr int kTB = 64;           // targets a block
constexpr int kTS = 256;          // sources a shared tile

template <typename Real, int KER>
__global__ void __launch_bounds__(kThreads)
p2p_ulist_kernel(const Real* __restrict__ xt, const int* __restrict__ tcnt,
                 const Real* __restrict__ xs, const Real* __restrict__ ns,
                 const Real* __restrict__ f, const int* __restrict__ fidx,
                 const int* __restrict__ srng, Real* __restrict__ out,
                 int T, long N) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1;
  constexpr bool kNormals = D::nrm;
  __shared__ Real sx[3][kTS];
  __shared__ Real sn[kNormals ? 3 : 1][kTS];
  __shared__ Real sf[K0][kTS];
  __shared__ Real red[kThreads][kR * K1];

  const long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kTB;          // the block's first target slot
  const int nt_box = tcnt ? max(0, min(tcnt[g], T)) : T;
  const int nt = max(0, min(nt_box - c0, kTB));
  const int ng = (nt + kR - 1) / kR;        // target groups
  const int nsub = ng ? kThreads / ng : 0;  // threads a group
  const int grp = ng ? tid % ng : 0, sub = ng ? tid / ng : 0;
  const bool live = ng && sub < nsub;
  const Real* xtg = xt + g * 3 * T;
  Real px[kR], py[kR], pz[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int t = min(c0 + grp * kR + r, T - 1);
    px[r] = xtg[t];
    py[r] = xtg[T + t];
    pz[r] = xtg[2 * T + t];
  }
  Real acc[kR][K1];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[r][j] = Real(0);

  const int sb = srng[2 * g];
  const int m_all = ng ? max(0, srng[2 * g + 1] - sb) : 0;
  for (int s0 = 0; s0 < m_all; s0 += kTS) {
    const int m = min(kTS, m_all - s0);
    __syncthreads();                        // the last tile is consumed
    for (int i = tid; i < m; i += kThreads) {
      const long j = (long)sb + s0 + i;
      const long row = fidx ? fidx[j] : j;
#pragma unroll
      for (int c = 0; c < 3; ++c) sx[c][i] = xs[c * N + j];
      if constexpr (kNormals) {
#pragma unroll
        for (int c = 0; c < 3; ++c) sn[c][i] = ns[c * N + j];
      }
#pragma unroll
      for (int c = 0; c < K0; ++c) sf[c][i] = f[row * K0 + c];
    }
    __syncthreads();
    if (!live) continue;
    Real part[kR][K1];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < K1; ++j) part[r][j] = Real(0);
#pragma unroll 4
    for (int i = sub; i < m; i += nsub) {
      Real fv[K0], nv[3];
#pragma unroll
      for (int c = 0; c < K0; ++c) fv[c] = sf[c][i];
      if constexpr (kNormals) {
#pragma unroll
        for (int c = 0; c < 3; ++c) nv[c] = sn[c][i];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        sctl::uker_acc<KER, true>(px[r] - sx[0][i], py[r] - sx[1][i],
                                  pz[r] - sx[2][i], fv, nv, part[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < K1; ++j) acc[r][j] += part[r][j];
  }

  // the shares of each group: a halving tree over sub, fixed order
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < K1; ++j) red[tid][r * K1 + j] = acc[r][j];
  for (int width = nsub; width > 1;) {
    const int half = (width + 1) / 2;
    __syncthreads();
    if (live && sub < width - half) {
#pragma unroll
      for (int k = 0; k < kR * K1; ++k) red[tid][k] += red[tid + half * ng][k];
    }
    width = half;
  }
  __syncthreads();
  Real* og = out + (g * T + c0) * K1;
  const int nslot = min(kTB, T - c0);
  for (int t = tid; t < nslot; t += kThreads) {
    const int gr = t / kR;
#pragma unroll
    for (int j = 0; j < K1; ++j)
      og[t * K1 + j] = t < nt ? red[gr][(t % kR) * K1 + j] : Real(0);
  }
}

template <typename Real>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const Real* xt, const int* tcnt, const Real* xs,
                   const Real* ns, const Real* f, const int* fidx,
                   const int* srng, Real* out, int G, int T, long N,
                   cudaStream_t stream) {
      dim3 grid(G, (T + kTB - 1) / kTB);
      p2p_ulist_kernel<Real, KER><<<grid, kThreads, 0, stream>>>(
          xt, tcnt, xs, ns, f, fidx, srng, out, T, N);
      return (int)cudaGetLastError();
    }
  };
};

template <typename Real>
int p2p_ulist(const Real* xt, const int* tcnt, const Real* xs,
              const Real* ns, const Real* f, const int* fidx, const int* srng,
              Real* out, int ker, int G, int T, int N, cudaStream_t stream) {
  using namespace sctl;
  if (G == 0 || T == 0) return 0;
  return dispatch_formula<Launch<Real>::template Of, kLapFxU, kLapDxU,
                          kLapFxdU, kStkFxU, kStkDxU, kStkFSxU>(
      ker, xt, tcnt, xs, ns, f, fidx, srng, out, G, T, (long)N, stream);
}

}  // namespace

// xt (G, 3, T), tcnt (G) int32 or null, xs (3, N), ns (3, N) (double
// layers only, else null), f (rows, k0), fidx (N) int32 or null, srng
// (G, 2) int32, out (G, T, k1); float32 (sctl_p2p_ulist) or float64
// (sctl_p2p_ulist_f64).  ker: the formula index of ukernels.cuh, one of
// the six kernels with a tree path.
SCTL_API int sctl_p2p_ulist(const float* xt, const int* tcnt,
                            const float* xs, const float* ns, const float* f,
                            const int* fidx, const int* srng, float* out,
                            int ker, int G, int T, int N,
                            cudaStream_t stream) {
  return p2p_ulist<float>(xt, tcnt, xs, ns, f, fidx, srng, out, ker, G, T,
                          N, stream);
}

SCTL_API int sctl_p2p_ulist_f64(const double* xt, const int* tcnt,
                                const double* xs, const double* ns,
                                const double* f, const int* fidx,
                                const int* srng, double* out, int ker, int G,
                                int T, int N, cudaStream_t stream) {
  return p2p_ulist<double>(xt, tcnt, xs, ns, f, fidx, srng, out, ker, G, T,
                           N, stream);
}
