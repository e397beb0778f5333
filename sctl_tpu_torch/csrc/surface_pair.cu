// S2M check potentials: each box's real source slots paired with the
// shared upward-check surface.
//
// Replaces: sctl_tpu/ops/pallas_sl.py `surface_pair` (pl.pallas_call at
// :254).  A box's real points are its first cnt[b] slots (int32 per box,
// Morton order, clipped here to cap; null means every slot, the JAX
// function's definition).  For surface point m and box b:
//   out[j, m, b] = sum_{s < cnt[b]} K(surf[m] - pts[:, b*cap + s])
//                  f[:, b*cap + s]
// (component j < k1, unscaled, box-local coordinates, r2 = 0 masked).
// The JAX function sums every slot, whose padding carries zero density,
// so leaving the padding out changes only the order of the f32 sums.
// The S2M kernels Laplace3D-FxU and -DxU and Stokes3D-FxU, -DxU and
// -FSxU; the double layers read the slots' normals (the JAX package's
// `nrm_l`, pallas_sl.py:197).  The formula is a template parameter
// (ukernels.cuh).
//
// Bound on the H100: the real pairs, one rsqrt each at 16 per SM per
// clock.  At 1e7 points, depth 6 (B = 262,144, cap 56, ns 152): 1.52e9
// real pairs, 0.36 ms; the bytes (the real slots once, the outputs,
// 0.2 GB) take 0.06 ms.  What holds a lean pair loop is the issue rate
// (128 lane-instructions a clock per SM): the Laplace single layer
// spends three subtractions, three instructions for r2, MUFU.RSQ, a
// compare and a select and one FMA a pair, about 10 (chip_smoke.py
// reads the loop's count with cuobjdump).  Every padded slot would be
// 2.23e9 slot pairs; the default formula form's rsqrtf carries a
// denormal fix-up; a lane a box would pay four shared loads a pair.
//
// Design: one warp a box, K boxes a warp in turn, kWarps warps a block.
// Each lane holds MC surface points (m = lane + 32 i) and their k1 sums
// in registers: MC = 5 at p = 6 (ns 152), 10 at p = 8 (ns 296); wider
// surfaces take ceil(ns / 320) passes.  The warp stages its box's real
// sources in tiles of kTile into its own float4 records, (x, y, z, f_0)
// and, for the Stokes densities and the normals, one or two more, and
// reads each record as a warp-wide broadcast: one shared load serves MC
// pairs.  The loop runs cnt[b] times, the same for every lane of the
// warp, so no lane idles on a padded slot, and the shared memory does
// not grow with cap.  Each lane sums a tile's pairs into fresh f32
// partial sums and adds them to its totals (in p2p_direct.cu one
// running f32 sum a thread drifted to 5.0e-6 of the maximum); no
// atomics, so a launch repeats bit for bit.  The output keeps the JAX
// layout (k1, ns, B): each warp puts a box's sums in its column of a
// shared stage (a row (j, m) of the block's kWarps K adjacent boxes, odd
// row stride), and once every warp has summed its K boxes the block
// writes the rows, kWarps K adjacent outputs each (128 bytes at K = 4).
// K boxes a warp (at most kMaxK, as many as the stage's kStageBytes
// take) average out the boxes' counts before the block's one barrier
// (sctl_tpu_torch/surface_sweep.py times kMaxK = 1, 2 and 4).  The
// TPU's bf16 hi/lo one-hot matmuls (pallas_sl.py:62-68) serve its matrix
// unit only and are not carried over.
//
// The double build (the float64 KIFMM on the card) is the same kernel on
// Real = double: the same real slots and per-box counts, fresh partial
// sums a tile, the lean double rsqrt (a MUFU seed and two Newton steps,
// ukernels.cuh) and the same summation order, so a launch repeats bit
// for bit.  A source's values take two double2 records where float's
// take one float4 (Rec16, common.cuh): the warp-wide broadcast reads
// stay single 16-byte loads.  A lane holds at most 5 surface points
// (kMaxMC of double), so p = 8 (ns 296) takes two passes: 10 points of
// double sums would pass the registers of 256 threads.  The output
// stage's doubles halve the boxes a warp (2 at p = 6).  Bound: the DP
// pipe (64 lane-operations a clock per SM): 14 DP instructions a Laplace
// pair (chip_smoke.py reads them from the SASS).
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kWarps = 8;    // warps a block
constexpr int kTile = 64;    // sources staged at a time, summed apart
constexpr int kStageBytes = 40 * 1024;  // output stage budget
constexpr int kMaxK = 4;     // boxes a warp at most (a power of two)

// surface points a lane in one pass at most
template <typename Real>
__host__ __device__ constexpr int max_mc() {
  return sizeof(Real) == 4 ? 10 : 5;
}

// 16-byte records of a source: x, y, z, the k0 densities, the normal
template <typename Real, int KER>
__host__ __device__ constexpr int records() {
  return sctl::records_of<Real>(3 + sctl::Dims<KER>::k0 +
                                (sctl::Dims<KER>::nrm ? 3 : 0));
}

// boxes a warp takes in turn: the most of kMaxK, kMaxK / 2, ..., 1
// whose stage (k1 rows of 32 MC surface points, kWarps K + 1 values
// each) fits kStageBytes
template <typename Real, int KER, int MC>
__host__ __device__ constexpr int boxes_per_warp(int k = kMaxK) {
  return k == 1 || sctl::Dims<KER>::k1 * 32 * MC * (int)sizeof(Real) *
                           (kWarps * k + 1) <= kStageBytes
             ? k
             : boxes_per_warp<Real, KER, MC>(k / 2);
}

// dynamic shared memory of a block: the warps' source tiles and the
// output stage
template <typename Real, int KER, int MC>
constexpr size_t smem_bytes() {
  return sizeof(typename sctl::Rec16<Real>::T) * kWarps * kTile *
             records<Real, KER>() +
         sizeof(Real) * sctl::Dims<KER>::k1 * 32 * MC *
             (kWarps * boxes_per_warp<Real, KER, MC>() + 1);
}

template <typename Real, int KER, int MC>
__global__ void __launch_bounds__(kWarps * 32)
surface_pair_kernel(const Real* __restrict__ surf,
                    const Real* __restrict__ pts,
                    const Real* __restrict__ nrm,
                    const Real* __restrict__ f,
                    const int* __restrict__ cnt, Real* __restrict__ out,
                    int ns, int B, int cap) {
  using D = sctl::Dims<KER>;
  using V = sctl::Rec16<Real>;
  using Rec = typename V::T;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  constexpr int R = records<Real, KER>(), W = V::W, NP = 32 * MC;
  constexpr int K = boxes_per_warp<Real, KER, MC>(), BB = kWarps * K;
  constexpr int ROW = BB + 1;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * BB;
  const int nb = min(BB, B - b0);
  const long N = (long)B * cap;
  Rec* st = reinterpret_cast<Rec*>(smem) + warp * kTile * R;
  Real* so = reinterpret_cast<Real*>(reinterpret_cast<Rec*>(smem) +
                                     kWarps * kTile * R);
  for (int m0 = 0; m0 < ns; m0 += NP) {   // passes over the surface
    Real cx[MC], cy[MC], cz[MC];
#pragma unroll
    for (int i = 0; i < MC; ++i) {
      const int m = m0 + lane + 32 * i;
      // a point past ns sums a dummy and is not stored
      cx[i] = m < ns ? surf[3 * m] : Real(0);
      cy[i] = m < ns ? surf[3 * m + 1] : Real(0);
      cz[i] = m < ns ? surf[3 * m + 2] : Real(0);
    }
    for (int k = 0; k < K; ++k) {      // the warp's boxes in turn
      // column c of the stage; a box past the last runs no tile
      const int c = warp * K + k, b = b0 + c;
      const int n = b >= B ? 0 : cnt ? max(0, min(cnt[b], cap)) : cap;
      const long g0 = (long)b * cap;
      Real acc[MC][K1];
#pragma unroll
      for (int i = 0; i < MC; ++i)
#pragma unroll
        for (int j = 0; j < K1; ++j) acc[i][j] = Real(0);
      for (int s0 = 0; s0 < n; s0 += kTile) {
        const int nt = min(kTile, n - s0);
        __syncwarp();
        for (int s = lane; s < nt; s += 32) {
          const long g = g0 + s0 + s;
          Real v[W * R];
#pragma unroll
          for (int q = 0; q < W * R; ++q) v[q] = Real(0);
#pragma unroll
          for (int q = 0; q < 3; ++q) v[q] = pts[q * N + g];
#pragma unroll
          for (int q = 0; q < K0; ++q) v[3 + q] = f[q * N + g];
#pragma unroll
          for (int q = 0; q < NN; ++q) v[3 + K0 + q] = nrm[q * N + g];
#pragma unroll
          for (int r = 0; r < R; ++r) st[s * R + r] = V::pack(v + W * r);
        }
        __syncwarp();
        Real part[MC][K1];
#pragma unroll
        for (int i = 0; i < MC; ++i)
#pragma unroll
          for (int j = 0; j < K1; ++j) part[i][j] = Real(0);
#pragma unroll 2
        for (int s = 0; s < nt; ++s) {
          Real v[W * R];
#pragma unroll
          for (int r = 0; r < R; ++r) V::unpack(st[s * R + r], v + W * r);
#pragma unroll
          for (int i = 0; i < MC; ++i)
            sctl::uker_acc<KER, true>(cx[i] - v[0], cy[i] - v[1],
                                      cz[i] - v[2], v + 3, v + 3 + K0,
                                      part[i]);
        }
#pragma unroll
        for (int i = 0; i < MC; ++i)
#pragma unroll
          for (int j = 0; j < K1; ++j) acc[i][j] += part[i][j];
      }
#pragma unroll
      for (int i = 0; i < MC; ++i)
#pragma unroll
        for (int j = 0; j < K1; ++j)
          so[(j * NP + 32 * i + lane) * ROW + c] = acc[i][j];
    }
    __syncthreads();
    // row (j, m) of the block's BB adjacent boxes
    const int np = min(NP, ns - m0);
    for (int i = threadIdx.x; i < K1 * NP * BB; i += blockDim.x) {
      const int row = i / BB, c = i - row * BB;
      const int j = row / NP, m = row - j * NP;
      if (c < nb && m < np)
        out[((long)j * ns + m0 + m) * B + b0 + c] = so[row * ROW + c];
    }
    __syncthreads();   // the stage is read: the next pass fills it
  }
}

// surface points a lane (MC) and passes for ns points: the fewest
// passes of at most max_mc a lane, each with the smallest instantiated
// MC that covers it
template <typename Real>
void layout(int ns, int* mc, int* passes) {
  const int rows = (ns + 31) / 32;
  *passes = (rows + max_mc<Real>() - 1) / max_mc<Real>();
  const int need = (rows + *passes - 1) / *passes;
  *mc = need <= 2 ? 2 : need <= 5 ? 5 : 10;
}

template <typename Real, int KER, int MC>
int run_mc(const Real* surf, const Real* pts, const Real* nrm,
           const Real* f, const int* cnt, Real* out, int ns, int B,
           int cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Real, KER, MC>();
  cudaError_t err = allow_smem(surface_pair_kernel<Real, KER, MC>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BB = kWarps * boxes_per_warp<Real, KER, MC>();
  const int grid = (B + BB - 1) / BB;
  surface_pair_kernel<Real, KER, MC><<<grid, kWarps * 32, smem, stream>>>(
      surf, pts, nrm, f, cnt, out, ns, B, cap);
  return (int)cudaGetLastError();
}

template <typename Real, int KER, int MC>
int blocks_mc(int* boxes, int* blocks) {
  constexpr size_t smem = smem_bytes<Real, KER, MC>();
  *boxes = boxes_per_warp<Real, KER, MC>();
  cudaError_t err = allow_smem(surface_pair_kernel<Real, KER, MC>, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, surface_pair_kernel<Real, KER, MC>, kWarps * 32, smem);
}

template <typename Real>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const Real* surf, const Real* pts, const Real* nrm,
                   const Real* f, const int* cnt, Real* out, int ns, int B,
                   int cap, cudaStream_t stream) {
      int mc, passes;
      layout<Real>(ns, &mc, &passes);
      if (mc == 2)
        return run_mc<Real, KER, 2>(surf, pts, nrm, f, cnt, out, ns, B,
                                    cap, stream);
      if constexpr (max_mc<Real>() >= 10) {
        if (mc == 10)
          return run_mc<Real, KER, 10>(surf, pts, nrm, f, cnt, out, ns, B,
                                       cap, stream);
      }
      return run_mc<Real, KER, 5>(surf, pts, nrm, f, cnt, out, ns, B, cap,
                                  stream);
    }
  };
};

// the layout at ns surface points and the resident blocks an SM, from
// the occupancy API
template <typename Real>
struct Occupancy {
  template <int KER>
  struct Of {
    static int run(int ns, int* lay, int* blocks) {
      layout<Real>(ns, &lay[0], &lay[1]);
      lay[2] = kWarps * 32;
      if (lay[0] == 2) return blocks_mc<Real, KER, 2>(&lay[3], blocks);
      if constexpr (max_mc<Real>() >= 10) {
        if (lay[0] == 10) return blocks_mc<Real, KER, 10>(&lay[3], blocks);
      }
      return blocks_mc<Real, KER, 5>(&lay[3], blocks);
    }
  };
};

template <typename Real>
int surface_pair(const Real* surf, const Real* pts, const Real* nrm,
                 const Real* f, const int* cnt, Real* out, int ker, int ns,
                 int B, int cap, cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch<Real>::template Of, kLapFxU, kLapDxU,
                          kStkFxU, kStkDxU, kStkFSxU>(
      ker, surf, pts, nrm, f, cnt, out, ns, B, cap, stream);
}

}  // namespace

// surf (ns, 3), pts (3, B*cap), nrm (3, B*cap) (double layers only,
// else null), f (k0, B*cap), cnt (B) int32 real slots of each box, its
// first (null: all cap), out (k1, ns, B); float32 (sctl_surface_pair)
// or float64 (sctl_surface_pair_f64).  ker: the formula index of
// ukernels.cuh, one of the S2M kernels.
SCTL_API int sctl_surface_pair(const float* surf, const float* pts,
                               const float* nrm, const float* f,
                               const int* cnt, float* out, int ker, int ns,
                               int B, int cap, cudaStream_t stream) {
  return surface_pair<float>(surf, pts, nrm, f, cnt, out, ker, ns, B, cap,
                             stream);
}

SCTL_API int sctl_surface_pair_f64(const double* surf, const double* pts,
                                   const double* nrm, const double* f,
                                   const int* cnt, double* out, int ker,
                                   int ns, int B, int cap,
                                   cudaStream_t stream) {
  return surface_pair<double>(surf, pts, nrm, f, cnt, out, ker, ns, B, cap,
                              stream);
}

// The layout at ns surface points of the float (f64 = 0) or double
// build, [surface points a lane, passes, threads a block, boxes a
// warp], into layout[0..3], and the resident blocks an SM of formula
// ker into *blocks (the occupancy API).
SCTL_API int sctl_surface_pair_occupancy(int ker, int f64, int ns,
                                         int* layout, int* blocks) {
  using namespace sctl;
  if (f64)
    return dispatch_formula<Occupancy<double>::Of, kLapFxU,
                            kLapDxU, kStkFxU, kStkDxU, kStkFSxU>(
        ker, ns, layout, blocks);
  return dispatch_formula<Occupancy<float>::Of, kLapFxU, kLapDxU,
                          kStkFxU, kStkDxU, kStkFSxU>(ker, ns, layout,
                                                      blocks);
}
