"""Spherical harmonic transforms, scalar and vector, and the Stokes
layer potentials on the sphere (counterpart of
sctl_tpu/linalg/sph_harm.py; reference: include/sctl/sph_harm.hpp:21-150,
sph_harm.txx:300-312 Grid2SHC / SHC2Grid, vector SH sph_harm.txx:
656-911, Stokes sphere layer potentials sph_harm.txx:913-2000).

Vector-basis conventions (the families the reference builds at
sph_harm.txx:1030-1042):
    V_nm = -(n+1) Y_nm r + r grad Y_nm   (decays as r^{-n-2} exterior)
    W_nm =      n Y_nm r + r grad Y_nm   (grows as r^{n-1} interior)
    X_nm = r x r grad Y_nm                (toroidal)
over this module's real packed scalar basis.

The Stokes single and double layers diagonalize in (n, family) with
radius-dependent scalars (sph_harm.txx:1050-1090 SL, 1258-1290 DL,
1873-1905 KSelf).  The traction at arbitrary targets (StokesEvalKL) is
forward-mode differentiation (`torch.func.jvp`) of the single-layer
velocity plus the spectral pressure.

Representation:
  grid   : (Nt, Np) samples, theta = Gauss-Legendre colatitude nodes
           (Nt >= p+1), phi = Np >= 2p+1 uniform longitudes.
  shc    : packed real coefficients, length (p+1)^2:
           for l = 0..p: [c_{l,0}, c_{l,1}, s_{l,1}, ..., c_{l,l},
           s_{l,l}] with the fully (4pi)-normalized real basis
           Y_{l,0} = N_l0 P_l0(cos t)
           Y_{l,m}^c = N_lm P_lm(cos t) cos(m phi)
           Y_{l,m}^s = N_lm P_lm(cos t) sin(m phi).

Analysis is an FFT over phi (`torch.fft`, cuFFT on the card) and then
one batched Legendre product over the orders m (`torch.bmm`: one
batched float64 GEMM with m as the batch); synthesis is the transpose.
The quadrature weights scale the Fourier data, so the Legendre table is
the only table of its size on the device.  The tables are built on the
host by the JAX package's numpy recurrence and kept for the process
(`_legendre_tables`); nothing is written to disk.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from .quadrule import leg_quad_rule


def sh_dim(p: int) -> int:
    return (p + 1) ** 2


@functools.lru_cache(maxsize=None)
def _legendre_tables(p: int, nt: int):
    """Normalized associated Legendre values at the GL nodes, kept for
    the process (p = 512: 1.08 GB; `_legendre_tables.cache_clear()`
    frees it).

    Returns (P (p+1, p+1, nt), theta (nt,), wts (nt,)): P[m, l] is
    N_lm P_l^m(cos theta) (zero for l < m)."""
    return _legendre_tables_build(p, nt)


def _legendre_tables_build(p: int, nt: int):
    """The stable (l, m) three-term recurrence on the fully normalized
    functions, upward in l and vector over m (the JAX package's)."""
    x01, w01 = leg_quad_rule(nt)
    ct = 1 - 2 * x01              # cos(theta) in (-1, 1), descending
    theta = np.arccos(ct)
    st = np.sqrt(1 - ct * ct)
    w = 2 * w01                   # d(cos t) weight on [-1,1]

    P = np.zeros((p + 1, p + 1, nt))
    P[0, 0] = 1.0 / np.sqrt(4 * np.pi)
    for m in range(1, p + 1):
        P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * st * P[m - 1,
                                                             m - 1]
    for l in range(1, p + 1):
        m2 = np.arange(0, l - 1)
        if len(m2):
            a = np.sqrt((4.0 * l * l - 1) / (l * l - m2 * m2))
            b = np.sqrt(((l - 1.0) ** 2 - m2 * m2)
                        / (4.0 * (l - 1.0) ** 2 - 1))
            P[m2, l] = a[:, None] * (ct[None] * P[m2, l - 1]
                                     - b[:, None] * P[m2, l - 2])
        P[l - 1, l] = np.sqrt(2 * l + 1.0) * ct * P[l - 1, l - 1]
    return P, theta, w


def _as(x, dtype, device):
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)     # torch takes no negative strides
    return torch.as_tensor(x, dtype=dtype, device=device)


def _bmm_analysis(T, X):
    """Per-order analysis product: T (m, l, n), X (B, n, m) real ->
    (B, m, l), out[b, m, l] = sum_n T[m, l, n] X[b, n, m]; one batched
    GEMM over m."""
    return torch.bmm(T, X.permute(2, 1, 0)).permute(2, 0, 1)


def _bmm_synthesis(T, C):
    """Per-order synthesis product: T (m, l, n), C (B, m, l) real ->
    (B, n, m), out[b, n, m] = sum_l T[m, l, n] C[b, m, l]; one batched
    GEMM over m."""
    return torch.bmm(T.transpose(1, 2), C.permute(1, 2, 0)
                     ).permute(2, 1, 0)


class SphericalHarmonics:
    """Transform object for degree p on an (nt, np_) grid, its tables on
    `device` in `dtype` (reference API: SphericalHarmonics::Grid2SHC /
    SHC2Grid / SHCEval / WriteVTK, sph_harm.hpp:21-150)."""

    def __init__(self, p: int, nt: int = None, np_: int = None,
                 device=None, dtype=torch.float64):
        self.p = p
        self.nt = nt or (p + 2)
        self.np_ = np_ or (2 * p + 2)
        if self.nt < p + 1 or self.np_ < 2 * p + 1:
            raise ValueError(f"SphericalHarmonics: grid ({self.nt}, "
                             f"{self.np_}) too small for p={p}")
        self.device = resolve_device(device)
        self.dtype = dtype
        P, theta, w = _legendre_tables(p, self.nt)
        self._P = _as(P, dtype, self.device)
        self.theta = theta
        self._w = _as(w, dtype, self.device)
        # packed slot k <-> flattened (cos|sin, m, l) slot of the
        # rectangular (2, p+1, p+1) stack: one gather each way
        li, mi, si = _packed_index(p)
        dim = (p + 1) ** 2
        flat = (si * (p + 1) + mi) * (p + 1) + li
        self._pk_gather = torch.as_tensor(flat, device=self.device)
        inv = np.full(2 * dim, dim, np.int64)      # dim -> zero pad
        inv[flat] = np.arange(dim)
        self._pk_scatter = torch.as_tensor(inv, device=self.device)
        self._lv = _as(li.astype(np.float64), dtype, self.device)
        # analysis/synthesis m-scalings of the real packed basis
        csc = np.full(p + 1, np.sqrt(2.0))
        csc[0] = 1.0
        ssc = np.full(p + 1, np.sqrt(2.0))
        ssc[0] = 0.0                               # no sin(0*phi) term
        sy_c = csc * self.np_ / 2
        sy_c[0] = self.np_
        self._an_c = _as(csc[:, None], dtype, self.device)
        self._an_s = _as(ssc[:, None], dtype, self.device)
        self._sy_c = _as(sy_c[:, None], dtype, self.device)
        self._sy_s = _as((ssc * self.np_ / 2)[:, None], dtype, self.device)
        self._dPQ = None           # lazy: vector transforms only

    def _t(self, x):
        return _as(x, self.dtype, self.device)

    @property
    def _dP(self):
        self._build_dpq()
        return self._dPQ[0]

    @property
    def _Q(self):
        self._build_dpq()
        return self._dPQ[1]

    def _build_dpq(self):
        """Pole-safe derivative and csc tables (m, l, nt) for the
        vector transforms and the gradient, built on the host on first
        use, so that the scalar transforms at high degree do not pay
        for them."""
        if self._dPQ is not None:
            return
        p = self.p
        ct = torch.as_tensor(np.cos(self.theta))
        st = torch.as_tensor(np.sin(self.theta))
        _, dP, Q = _legendre_trio(p, ct, st)         # (nt, p+2, p+2)
        self._dPQ = tuple(self._t(a[:, :p + 1, :p + 1].permute(1, 2, 0))
                          for a in (dP, Q))

    # -- grid <-> coefficients -------------------------------------------
    # Real orthonormal basis: Y_l0 = P[0,l];
    # Y^{c,s}_{lm} = sqrt(2) P[m,l] {cos,sin}(m phi).
    def _fourier(self, f):
        """(B, nt, np_) -> the weighted Fourier data (B, nt, p+1) of the
        analysis (the quadrature weights applied here, not to P)."""
        fm = torch.fft.rfft(f, dim=-1)[..., :self.p + 1] \
            * (2 * np.pi / self.np_)
        return fm * self._w[:, None]

    def _synth(self, fm):
        """(B, nt, p+1) complex -> (B, nt, np_): zero-padded to the
        half spectrum, inverse real FFT over phi."""
        nf = self.np_ // 2 + 1
        fm = torch.nn.functional.pad(fm, (0, nf - (self.p + 1)))
        return torch.fft.irfft(fm, n=self.np_, dim=-1)

    def _legendre_pack(self, fm, sc, ss):
        """(B, nt, p+1) complex Fourier data -> packed (B, (p+1)^2): the
        per-order Legendre product of its real and negated imaginary
        parts, scaled by sc and ss (m, 1)."""
        B = fm.shape[0]
        cs = _bmm_analysis(self._P, torch.cat([fm.real, -fm.imag]))
        return self._pack(cs[:B] * sc, cs[B:] * ss)

    def grid2shc(self, f) -> torch.Tensor:
        """(.., nt, np_) -> (.., (p+1)^2) analysis (reference: Grid2SHC,
        sph_harm.txx:300): rfft over phi, then the weighted Legendre
        product per order m."""
        f = self._t(f)
        fm = self._fourier(f.reshape((-1,) + f.shape[-2:]))
        return self._legendre_pack(fm, self._an_c, self._an_s).reshape(
            f.shape[:-2] + (-1,))

    def shc2grid(self, shc) -> torch.Tensor:
        """(.., (p+1)^2) -> (.., nt, np_) synthesis (reference: SHC2Grid,
        sph_harm.txx:300-312)."""
        shc = self._t(shc)
        batch = shc.shape[:-1]
        c, s = self._unpack(shc.reshape(-1, shc.shape[-1]))
        B = c.shape[0]
        AB = _bmm_synthesis(self._P, torch.cat([c * self._sy_c,
                                                s * self._sy_s]))
        X = self._synth(torch.complex(AB[:B], -AB[B:]))
        return X.reshape(batch + X.shape[-2:])

    def shc2grid_grad(self, shc):
        """(.., (p+1)^2) -> (X, X_theta, X_phi), each (.., nt, np_): the
        synthesis and its theta- and phi-derivatives on the grid
        (reference: SHC2Grid with the X_theta/X_phi outputs,
        sph_harm.hpp:64-67, SHC2Grid_ sph_harm.txx:2221: theta through
        the derivative tables, phi as the im-scaled Fourier synthesis)."""
        shc = self._t(shc)
        batch = shc.shape[:-1]
        c, s = self._unpack(shc.reshape(-1, shc.shape[-1]))
        B = c.shape[0]
        cs = torch.cat([c * self._sy_c, s * self._sy_s])
        AB = _bmm_synthesis(self._P, cs)
        ABt = _bmm_synthesis(self._dP, cs)
        fm = torch.complex(AB[:B], -AB[B:])
        mm = torch.arange(self.p + 1, dtype=self.dtype,
                          device=self.device)
        out = (self._synth(fm),
               self._synth(torch.complex(ABt[:B], -ABt[B:])),
               self._synth(fm * (1j * mm)))
        return tuple(X.reshape(batch + X.shape[-2:]) for X in out)

    def shc2grid_transpose(self, X) -> torch.Tensor:
        """Adjoint of shc2grid: grid values -> packed coefficients by
        the TRANSPOSE (not the inverse) of the synthesis operator
        (reference: SHC2GridTranspose, sph_harm.hpp:160).  X (.., nt,
        np_).  The inverse real FFT's adjoint is the forward one scaled
        by 1/np_, doubled for the orders 0 < m < np_/2 (np_ > 2p, so no
        order here is the Nyquist one); then the synthesis scalings and
        the Legendre product."""
        X = self._t(X)
        ck = torch.full((self.p + 1,), 2.0 / self.np_, dtype=self.dtype,
                        device=self.device)
        ck[0] = 1.0 / self.np_
        fm = torch.fft.rfft(X.reshape((-1,) + X.shape[-2:]),
                            dim=-1)[..., :self.p + 1] * ck
        return self._legendre_pack(fm, self._sy_c, self._sy_s).reshape(
            X.shape[:-2] + (-1,))

    def shc2pole(self, shc) -> torch.Tensor:
        """(.., (p+1)^2) -> (.., 2): values at the north (theta=0) and
        south (theta=pi) poles (reference: SHC2Pole, sph_harm.hpp:79,
        sph_harm.txx:350; only the m=0 modes are nonzero there)."""
        p = self.p
        shc = self._t(shc)
        P0 = _legendre_trio(p, self._t([1.0, -1.0]), self._t([0.0, 0.0])
                            )[0][:, 0, :p + 1]        # (2, p+1)
        idx = torch.as_tensor([l * l for l in range(p + 1)],
                              device=self.device)     # c_{l,0} slots
        return torch.einsum("...l,kl->...k", shc[..., idx], P0)

    def write_vtk(self, path: str, coord_shc=None, value_shc=None,
                  p_out: int = None):
        """Write the spherical grid as a quad surface mesh (.vtu),
        optionally warped by a 3-component coordinate SHC and colored by
        a value SHC (reference: SphericalHarmonics::WriteVTK,
        sph_harm.hpp:81, sph_harm.txx:371-455)."""
        from ..tree.vtu import VTUData
        po = p_out if p_out is not None else self.p
        sh = self if po == self.p else SphericalHarmonics(
            po, device=self.device, dtype=self.dtype)
        nt, np_ = sh.nt, sh.np_
        theta = sh.theta
        phi = 2 * np.pi * np.arange(np_) / np_

        def resampled(cs):
            # degree p -> p_out: the packed layout is ordered by degree,
            # so truncate or zero-pad (the JAX package's resampling
            # through self's grid fails on sh's grid, sph_harm.py:305)
            n = sh_dim(po)
            cs = (cs[:, :n] if cs.shape[1] >= n else
                  torch.nn.functional.pad(cs, (0, n - cs.shape[1])))
            return sh.shc2grid(cs).cpu().numpy()

        if coord_shc is not None:
            X = resampled(self._t(coord_shc).reshape(3, -1))
        else:
            st, ct = np.sin(theta), np.cos(theta)
            X = np.stack([st[:, None] * np.cos(phi)[None, :],
                          st[:, None] * np.sin(phi)[None, :],
                          ct[:, None] * np.ones((1, np_))])
        pts = X.reshape(3, -1).T                         # (nt*np_, 3)
        # quads between adjacent theta rows, phi wraps around
        i = np.arange(nt - 1)[:, None]
        j = np.arange(np_)[None, :]
        j1 = (j + 1) % np_
        conn = np.stack([i * np_ + j, i * np_ + j1,
                         (i + 1) * np_ + j1, (i + 1) * np_ + j],
                        axis=-1).reshape(-1, 4)
        data = VTUData()
        fields = {}
        if value_shc is not None:
            vs = self._t(value_shc)
            vs = vs.reshape(-1, vs.shape[-1])
            fields["value"] = resampled(vs).reshape(len(vs), -1).T
        data.add_quads(pts, conn, **fields)
        data.write_vtu(path)
        return data

    def _unpack(self, shc):
        """packed -> (c[.., m, l], s[.., m, l]) with zeros for l<m: one
        gather."""
        p = self.p
        batch = shc.shape[:-1]
        z = torch.zeros(batch + (1,), dtype=shc.dtype, device=shc.device)
        cs = torch.cat([shc, z], dim=-1)[..., self._pk_scatter]
        cs = cs.reshape(batch + (2, p + 1, p + 1))
        return cs[..., 0, :, :], cs[..., 1, :, :]

    def _pack(self, c, s):
        """(c[.., m, l], s[.., m, l]) -> packed (.., (p+1)^2): one
        gather."""
        batch = c.shape[:-2]
        cs = torch.stack([c, s], dim=-3).reshape(batch + (-1,))
        return cs[..., self._pk_gather]

    def _grid_trig(self):
        """cos/sin of the grid's theta (nt, 1) and phi (1, np_)."""
        theta = self._t(self.theta)
        phi = 2 * np.pi * torch.arange(
            self.np_, dtype=self.dtype, device=self.device) / self.np_
        return (torch.cos(theta)[:, None], torch.sin(theta)[:, None],
                torch.cos(phi)[None, :], torch.sin(phi)[None, :])

    # -- vector transforms -------------------------------------------------
    def grid2vecshc(self, F) -> torch.Tensor:
        """(.., 3, nt, np_) Cartesian vector field -> (.., 3, (p+1)^2)
        packed (V, W, X) coefficients (reference: Grid2VecSHC,
        sph_harm.txx:656-758).

        Rotate to spherical components; y = scalar analysis of f_r;
        tangential projections onto Psi = r grad Y and Phi = r x Psi by
        per-order products with the dP/dtheta and m P/sin(theta)
        tables; then v = (n g - y)/(2n+1), w = ((n+1) g + y)/(2n+1)
        (the reference's phiV/phiW mixing, sph_harm.txx:744-746)."""
        p = self.p
        F = self._t(F)
        batch = F.shape[:-3]
        F = F.reshape((-1,) + F.shape[-3:])
        ct, st, cp, sp = self._grid_trig()
        fx, fy, fz = F[:, 0], F[:, 1], F[:, 2]
        f_r = st * cp * fx + st * sp * fy + ct * fz
        f_t = ct * cp * fx + ct * sp * fy - st * fz
        f_p = -sp * fx + cp * fy

        y = self.grid2shc(f_r)                     # (B, M)
        fmt = self._fourier(f_t)                   # (B, nt, m)
        fmp = self._fourier(f_p)
        B = fmt.shape[0]
        X4 = torch.cat([fmt.real, -fmt.imag, fmp.real, -fmp.imag])
        eD = _bmm_analysis(self._dP, X4).split(B)  # Ct, St, Cp, Sp
        eQ = _bmm_analysis(self._Q, X4).split(B)
        mv = torch.arange(p + 1, dtype=self.dtype,
                          device=self.device)[:, None]      # (m, 1)
        an = self._an_c
        gc = an * (eD[0] - mv * eQ[3])             # (B, m, l)
        gs = an * (eD[1] + mv * eQ[2])
        xc = an * (mv * eQ[1] + eD[2])
        xs = an * (-mv * eQ[0] + eD[3])
        ll = torch.arange(p + 1, dtype=self.dtype, device=self.device)
        inv = 1.0 / torch.where(ll > 0, ll * (ll + 1), 1.0)
        g = self._pack(gc * inv, gs * inv)         # (B, M)
        x = self._pack(xc * inv, xs * inv)
        lv = self._lv
        v = (lv * g - y) / (2 * lv + 1)
        w = ((lv + 1) * g + y) / (2 * lv + 1)
        w[:, 0] = 0.0                              # W_00 = X_00 = 0
        x[:, 0] = 0.0
        return torch.stack([v, w, x], dim=-2).reshape(batch + (3, -1))

    def vecshc2grid(self, S) -> torch.Tensor:
        """(.., 3, (p+1)^2) packed (V, W, X) -> (.., 3, nt, np_)
        Cartesian grid values (reference: VecSHC2Grid,
        sph_harm.txx:758-859)."""
        p = self.p
        S = self._t(S)
        batch = S.shape[:-2]
        S = S.reshape(-1, 3, S.shape[-1])
        v, w, x = S[:, 0], S[:, 1], S[:, 2]
        lv = self._lv
        f_r = self.shc2grid(-(lv + 1) * v + lv * w)

        gc, gs = self._unpack(v + w)               # (B, m, l)
        xc, xs = self._unpack(x)
        B = gc.shape[0]
        C4 = torch.cat([gc, gs, xc, xs])
        eD = _bmm_synthesis(self._dP, C4).split(B)  # (B, nt, m) each
        eQ = _bmm_synthesis(self._Q, C4).split(B)
        # the m-factor lands on the output column axis
        mv = torch.arange(p + 1, dtype=self.dtype, device=self.device)
        sy = self._sy_c[:, 0]
        At = eD[0] - mv * eQ[3]
        Bt = eD[1] + mv * eQ[2]
        Ap = mv * eQ[1] + eD[2]
        Bp = -mv * eQ[0] + eD[3]
        f_t = self._synth(sy * torch.complex(At, -Bt))
        f_p = self._synth(sy * torch.complex(Ap, -Bp))

        ct, st, cp, sp = self._grid_trig()
        fx = st * cp * f_r + ct * cp * f_t - sp * f_p
        fy = st * sp * f_r + ct * sp * f_t + cp * f_p
        fz = ct * f_r - st * f_t
        return torch.stack([fx, fy, fz], dim=-3).reshape(
            batch + (3, self.nt, self.np_))

    def vecshc_eval(self, S, theta, phi) -> torch.Tensor:
        """Evaluate the vector SH expansion at arbitrary (theta, phi) on
        the unit sphere -> Cartesian (.., N, 3) (reference: VecSHCEval,
        sph_harm.txx:861-911)."""
        S = self._t(S)
        return _vsh_synth_at(S[..., 0, :], S[..., 1, :], S[..., 2, :],
                             self.p, self._t(theta), self._t(phi))

    # -- pointwise evaluation ----------------------------------------------
    def eval(self, shc, theta, phi) -> torch.Tensor:
        """Evaluate one SH expansion (p+1)^2 at arbitrary (theta, phi)
        points (M,) -> (M,) (reference: SHCEval)."""
        p = self.p
        theta, phi = self._t(theta), self._t(phi)
        c, s = self._unpack(self._t(shc))
        P = _legendre_trio(p, torch.cos(theta), torch.sin(theta)
                           )[0][:, :p + 1, :p + 1]   # (M, m, l)
        gm = torch.einsum("Mml,ml->mM", P, c)
        hm = torch.einsum("Mml,ml->mM", P, s)
        mphi = torch.arange(p + 1, dtype=self.dtype,
                            device=self.device)[:, None] * phi
        return (self._an_c * (gm * torch.cos(mphi)
                              + hm * torch.sin(mphi))).sum(0)


# -- vector spherical harmonics + Stokes sphere layer potentials --------
#
# Packed vector coefficients: S[..., 3, (p+1)^2] with family axis
# (V, W, X) over the scalar packed layout.  w_00 and x_00 are
# identically zero (W_00 = X_00 = 0).


@functools.lru_cache(maxsize=None)
def _packed_index(p: int):
    """Constant index maps for the packed layout: for packed slot k,
    (l_k, m_k, is_sin_k)."""
    l_idx, m_idx, s_idx = [], [], []
    for l in range(p + 1):
        l_idx.append(l), m_idx.append(0), s_idx.append(0)
        for m in range(1, l + 1):
            l_idx.extend([l, l]), m_idx.extend([m, m])
            s_idx.extend([0, 1])
    return (np.array(l_idx), np.array(m_idx), np.array(s_idx))


@functools.lru_cache(maxsize=None)
def _trio_coeffs(p: int):
    """The recurrence coefficients of `_legendre_trio` as (p+2, p+2)
    [l, m] numpy tables, zero where a step does not apply: a, b of the
    upward step (m <= l-2), f of the first off-diagonal (m = l-1), and
    the derivative ladder's two factors (m <= l)."""
    n = p + 2
    a = np.zeros((n, n))
    b = np.zeros((n, n))
    for l in range(2, n):
        m = np.arange(0, l - 1)
        a[l, m] = np.sqrt((4.0 * l * l - 1) / (l * l - m * m))
        b[l, m] = np.sqrt(((l - 1.0) ** 2 - m * m)
                          / (4.0 * (l - 1.0) ** 2 - 1))
    L, M = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ok = L >= M
    up = np.where(ok, np.sqrt(np.maximum((L - M) * (L + M + 1.0), 0)), 0)
    dn = np.where(ok, np.sqrt(np.maximum((L + M) * (L - M + 1.0), 0)), 0)
    return a, b, up.T, dn.T, ok.T            # ladder factors as [m, l]


def _legendre_trio(p: int, ct, st):
    """Normalized associated-Legendre tables at arbitrary points, for
    m, l <= p+1: P[m, l], dPdt[m, l] (theta-derivative, pole-safe
    ladder), Q[m, l] = P/sin(theta) (pole-safe recurrence, m >= 1).

    ct, st (..., N) tensors -> three (..., N, p+2, p+2) [m, l] tensors, zero
    where l < m.  The JAX package's per-(m, l) recurrence, vector over
    m and in the same operation order; no in-place writes, so
    `torch.func.jvp` passes through it."""
    n = p + 2
    dev, dt = ct.device, ct.dtype
    a, b, up, dn, ok = (torch.as_tensor(x, device=dev) for x in
                        _trio_coeffs(p))
    a, b = a.to(dt), b.to(dt)
    c00 = 1.0 / np.sqrt(4 * np.pi)
    # the diagonals P[m][m], Q[m][m], sequential in m
    dQ = [None, -np.sqrt(3.0 / 2.0) * c00 * torch.ones_like(ct)]
    dP = [c00 * torch.ones_like(ct), dQ[1] * st]
    for m in range(2, n):
        f = -np.sqrt((2 * m + 1) / (2.0 * m))
        dQ.append(f * st * dQ[m - 1])
        dP.append(dQ[m] * st)
    eye = torch.eye(n, dtype=dt, device=dev)
    qrow = torch.ones(n, dtype=dt, device=dev)
    qrow[0] = 0.0                                # Q has no m = 0 row
    zero = torch.zeros(ct.shape + (n,), dtype=dt, device=dev)
    colsP, colsQ = [zero, zero], [zero, zero]    # columns l-2, l-1
    ctc = ct[..., None]
    for l in range(n):
        recP = a[l] * (ctc * colsP[-1] - b[l] * colsP[-2])
        recQ = qrow * a[l] * (ctc * colsQ[-1] - b[l] * colsQ[-2])
        dgP = dP[l][..., None] * eye[l]
        dgQ = dQ[l][..., None] * eye[l] if l >= 1 else zero
        if l >= 1:
            f = np.sqrt(2 * (l - 1) + 3.0)
            recP = recP + (f * ct * dP[l - 1])[..., None] * eye[l - 1]
            if l >= 2:
                recQ = recQ + (f * ct * dQ[l - 1])[..., None] \
                    * eye[l - 1]
        colsP.append(recP + dgP)
        colsQ.append(recQ + dgQ)
    P = torch.stack(colsP[2:], dim=-1)           # (..., N, m, l)
    Q = torch.stack(colsQ[2:], dim=-1)
    # pole-safe derivative ladder (Condon-Shortley-phased normalized
    # functions): dP[m][l] = (sqrt((l-m)(l+m+1)) P[m+1][l]
    #                         - sqrt((l+m)(l-m+1)) P[m-1][l]) / 2,
    # P[-1] := -P[1]
    hi = torch.cat([P[..., 1:, :], zero[..., None, :]], dim=-2)
    lo = torch.cat([-P[..., 1:2, :], P[..., :-1, :]], dim=-2)
    dPt = torch.where(ok, 0.5 * (up.to(dt) * hi - dn.to(dt) * lo), 0.0)
    return P, dPt, Q


def _vsh_bases(p: int, theta, phi):
    """Angular basis matrices at (..., N) points, packed over (p+1)^2
    slots: BY = Y, BT = dY/dtheta, BP = (dY/dphi)/sin(theta), each
    (..., N, M), pole-safe (Q = P/sin).  Real basis:
    Y^c = sq2*P*cos(m phi), Y^s = sq2*P*sin(m phi) (sq2 = 1 at m=0)."""
    P, dP, Q = _legendre_trio(p, torch.cos(theta), torch.sin(theta))
    l_idx, m_idx, s_idx = _packed_index(p)
    dev, dt = theta.device, theta.dtype
    li, mi = (torch.as_tensor(x, device=dev) for x in (l_idx, m_idx))
    is_sin = torch.as_tensor(s_idx == 1, device=dev)
    sq = torch.as_tensor(np.where(m_idx == 0, 1.0, np.sqrt(2.0)),
                         dtype=dt, device=dev)
    mv = mi.to(dt)
    mphi = mv * phi[..., None]                   # (N, M)
    cosm, sinm = torch.cos(mphi), torch.sin(mphi)
    trig = torch.where(is_sin, sinm, cosm)
    # d/dphi: cos -> -m sin;  sin -> m cos
    dtrig = torch.where(is_sin, mv * cosm, (-mv) * sinm)
    BY = sq * P[..., mi, li] * trig
    BT = sq * dP[..., mi, li] * trig
    BP = torch.where(mi == 0, 0.0, sq * Q[..., mi, li] * dtrig)
    return BY, BT, BP


def _sph_to_cart(theta, phi, u_r, u_t, u_p):
    """Rotate spherical components to Cartesian (the Q matrix of
    sph_harm.txx:887-895)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    ux = st * cp * u_r + ct * cp * u_t - sp * u_p
    uy = st * sp * u_r + ct * sp * u_t + cp * u_p
    uz = ct * u_r - st * u_t
    return torch.stack([ux, uy, uz], dim=-1)


def _vsh_synth_at(veff, weff, xeff, p, theta, phi,
                  per_target: bool = False):
    """Evaluate sum_k veff V_k + weff W_k + xeff X_k at (theta, phi).
    Coefficients are shared (.., M) by default, or per-target
    (.., N, M) with per_target=True.  Returns Cartesian (.., N, 3)."""
    BY, BT, BP = _vsh_bases(p, theta, phi)       # (N, M)
    lv = torch.as_tensor(_packed_index(p)[0].astype(np.float64),
                         dtype=theta.dtype, device=theta.device)
    geff = veff + weff
    if per_target:
        def contract(c, B):
            return (c * B).sum(-1)
    else:
        def contract(c, B):
            return torch.einsum("...k,nk->...n", c, B)
    u_r = contract(-(lv + 1) * veff + lv * weff, BY)
    u_t = contract(geff, BT) - contract(xeff, BP)
    u_p = contract(geff, BP) + contract(xeff, BT)
    return _sph_to_cart(theta, phi, u_r, u_t, u_p)


def _coord_to_sph(coord):
    x, y, z = coord[..., 0], coord[..., 1], coord[..., 2]
    rho = torch.sqrt(x * x + y * y)
    r = torch.sqrt(x * x + y * y + z * z)
    return r, torch.atan2(rho, z), torch.atan2(y, x)


def _stokes_factors(kind: str, p: int, r, interior: bool):
    """Per-degree radius factors (fVV, fVW, fWW, fWV, fXX), each
    (N, p+1): fAB = contribution of an A-family density coefficient to
    the B-family of the resulting field.  Coefficient tables from the
    reference (SL sph_harm.txx:1050-1090, DL 1258-1290, KSelf
    1873-1905)."""
    n = torch.arange(p + 1, dtype=r.dtype, device=r.device)
    r = r[..., None]                               # (N, 1)

    def rp(e):
        return r ** e

    z = torch.zeros_like(r * n)
    if kind == "SL":
        if interior:
            fVV = n / ((2 * n + 1) * (2 * n + 3)) * rp(n + 1)
            fVW = -(n + 1) / (4 * n + 2) * (rp(n - 1) - rp(n + 1))
            fWW = (n + 1) / ((2 * n + 1) * (2 * n - 1)) * rp(n - 1)
            fWV = z
            fXX = 1 / (2 * n + 1) * rp(n)
        else:
            fVV = n / ((2 * n + 1) * (2 * n + 3)) * rp(-n - 2)
            fVW = z
            fWW = (n + 1) / ((2 * n + 1) * (2 * n - 1)) * rp(-n)
            fWV = n / (4 * n + 2) * (rp(-n - 2) - rp(-n))
            fXX = 1 / (2 * n + 1) * rp(-n - 1)
    elif kind == "DL":
        if interior:
            fVV = -2 * n * (n + 2) / ((2 * n + 1) * (2 * n + 3)) \
                * rp(n + 1)
            fVW = -(n + 1) * (n + 2) / (2 * n + 1) \
                * (rp(n + 1) - rp(n - 1))
            fWW = -(2 * n * n + 1) / ((2 * n + 1) * (2 * n - 1)) \
                * rp(n - 1)
            fWV = z
            fXX = -(n + 2) / (2 * n + 1) * rp(n)
        else:
            fVV = (2 * n * n + 4 * n + 3) / ((2 * n + 1) * (2 * n + 3)) \
                * rp(-n - 2)
            fVW = z
            fWW = 2 * (n + 1) * (n - 1) / ((2 * n + 1) * (2 * n - 1)) \
                * rp(-n)
            fWV = 2 * n * (n - 1) / (4 * n + 2) * (rp(-n - 2) - rp(-n))
            fXX = (n - 1) / (2 * n + 1) * rp(-n - 1)
    elif kind == "KSELF":
        if interior:
            fVV = (2 * n * n + 4 * n + 3) / ((2 * n + 1) * (2 * n + 3)) \
                * rp(n)
            fVW = (n + 1) * (n - 1) / (2 * n + 1) * (rp(n) - rp(n - 2))
            fWW = 2 * (n + 1) * (n - 1) / ((2 * n + 1) * (2 * n - 1)) \
                * rp(n - 2)
            fWV = z
            fXX = (n - 1) / (2 * n + 1) * rp(n - 1)
        else:
            fVV = -2 * n * (n + 2) / ((2 * n + 1) * (2 * n + 3)) \
                * rp(-n - 3)
            fVW = z
            fWW = -(2 * n * n + 1) / ((2 * n + 1) * (2 * n - 1)) \
                * rp(-n - 1)
            fWV = n * (n + 2) / (2 * n + 1) * (rp(-n - 1) - rp(-n - 3))
            fXX = -(n + 2) / (2 * n + 1) * rp(-n - 2)
    else:
        raise ValueError(kind)
    # n = 0: only the V family is nonzero in the density; guard the
    # 1/(2n-1)-type singularities on unused families.
    mask0 = n == 0
    return (fVV, fVW, torch.where(mask0, 0.0, fWW),
            torch.where(mask0, 0.0, fWV), torch.where(mask0, 0.0, fXX))


def _on_device(S, coord, device, dtype):
    dev = resolve_device(device)
    return _as(S, dtype, dev), _as(coord, dtype, dev)


def _stokes_apply(kind: str, S, p: int, coord, interior: bool):
    """Shared spectral layer-potential evaluator: S (.., 3, M) packed
    (V, W, X) density coefficients, coord (N, 3) -> (.., N, 3)."""
    r, theta, phi = _coord_to_sph(coord)
    fVV, fVW, fWW, fWV, fXX = _stokes_factors(kind, p, r, interior)
    l_idx = torch.as_tensor(_packed_index(p)[0], device=coord.device)
    v = S[..., 0, :][..., None, :]                 # (.., 1, M)
    w = S[..., 1, :][..., None, :]
    x = S[..., 2, :][..., None, :]

    def Fl(f):
        return f[..., l_idx]

    veff = Fl(fVV) * v + Fl(fWV) * w               # (.., N, M)
    weff = Fl(fVW) * v + Fl(fWW) * w
    xeff = Fl(fXX) * x
    return _vsh_synth_at(veff, weff, xeff, p, theta, phi,
                         per_target=True)


def stokes_eval_sl(S, p: int, coord, interior: bool, device=None,
                   dtype=torch.float64) -> torch.Tensor:
    """Stokes single-layer potential from VSH density coefficients S
    (.., 3, (p+1)^2) at targets coord (N, 3) -> (.., N, 3) (reference:
    StokesEvalSL, sph_harm.hpp:122-129, sph_harm.txx:913-1125)."""
    S, coord = _on_device(S, coord, device, dtype)
    return _stokes_apply("SL", S, p, coord, interior)


def stokes_eval_dl(S, p: int, coord, interior: bool, device=None,
                   dtype=torch.float64) -> torch.Tensor:
    """Stokes double-layer potential (reference: StokesEvalDL,
    sph_harm.txx:1127-1339)."""
    S, coord = _on_device(S, coord, device, dtype)
    return _stokes_apply("DL", S, p, coord, interior)


def stokes_eval_kself(S, p: int, coord, interior: bool, device=None,
                      dtype=torch.float64) -> torch.Tensor:
    """Traction of the single-layer field with radial normal
    (reference: StokesEvalKSelf, sph_harm.txx:1739-2000)."""
    S, coord = _on_device(S, coord, device, dtype)
    return _stokes_apply("KSELF", S, p, coord, interior)


def stokes_pressure_sl(S, p: int, coord, interior: bool, device=None,
                       dtype=torch.float64) -> torch.Tensor:
    """Pressure of the single-layer Stokes field (the PV/PW terms of
    the reference's StokesEvalKL, sph_harm.txx:1590-1636):
    interior p(x) = sum v_nm (n+1) r^n Y_nm; exterior
    p(x) = sum w_nm n r^{-n-1} Y_nm."""
    S, coord = _on_device(S, coord, device, dtype)
    r, theta, phi = _coord_to_sph(coord)
    n = torch.arange(p + 1, dtype=dtype, device=coord.device)
    l_idx = torch.as_tensor(_packed_index(p)[0], device=coord.device)
    if interior:
        fac = ((n + 1) * r[..., None] ** n)[..., l_idx]
        c = S[..., 0, :]
    else:
        fac = (n * r[..., None] ** (-n - 1))[..., l_idx]
        c = S[..., 1, :]
    BY, _, _ = _vsh_bases(p, theta, phi)
    return ((c[..., None, :] * fac) * BY).sum(-1)


def stokes_eval_kl(S, p: int, coord, norm, interior: bool, device=None,
                   dtype=torch.float64) -> torch.Tensor:
    """Traction of the single-layer Stokes field at arbitrary targets
    with arbitrary normals (reference: StokesEvalKL,
    sph_harm.txx:1341-1739): t = (grad u + grad u^T - p I) . n, with
    grad u by forward-mode differentiation (`torch.func.jvp`, one
    tangent per coordinate axis) of the spectral single-layer velocity
    and p from the spectral pressure."""
    S, coord = _on_device(S, coord, device, dtype)
    norm = _as(norm, dtype, coord.device)

    def u_fn(c):
        return _stokes_apply("SL", S, p, c, interior)

    cols = []
    for j in range(3):
        tang = torch.zeros_like(coord)
        tang[..., j] = 1.0
        cols.append(torch.func.jvp(u_fn, (coord,), (tang,))[1])
    J = torch.stack(cols, dim=-1)                  # (.., N, 3(i), 3(j))
    pr = stokes_pressure_sl(S, p, coord, interior, device=coord.device,
                            dtype=dtype)
    sym = J + J.transpose(-1, -2)
    return torch.einsum("...ij,...j->...i", sym, norm) \
        - pr[..., None] * norm


# -- SHCArrange coefficient layouts (reference: sph_harm.hpp:21-36) ------

class SHCArrange:
    """The reference's three coefficient storage layouts.  The (Ar, Ai)
    pair of degree-order (n, m) is this module's real-basis pair
    (c_{n,m}, s_{n,m}) (the layouts are storage ARRANGEMENTS; the
    reference's complex e^{imφ} pairing differs from the real basis only
    by fixed per-m scalings that cancel in any arrange -> rearrange
    roundtrip)."""
    ALL = "ALL"                        # (p+1)^2 complex, row-major
    ROW_MAJOR = "ROW_MAJOR"            # (p+1)(p+2)/2 complex, lower tri
    COL_MAJOR_NONZERO = "COL_MAJOR_NONZERO"  # (p+1)^2 reals, col-major


@functools.lru_cache(maxsize=None)
def _arrange_maps(p: int, arrange: str):
    """(gather, out_len): out[i] = packed[gather[i]] (or 0 where
    gather < 0).  All three layouts are index maps of the packed real
    coefficients."""
    li, mi, si = _packed_index(p)      # packed slot k -> (l, m, c|s)
    dim = (p + 1) ** 2
    slot = np.full((2, p + 1, p + 1), -1, np.int64)   # (c|s, m, l)
    slot[si, mi, li] = np.arange(dim)
    if arrange == SHCArrange.ALL:
        g = np.full(2 * (p + 1) ** 2, -1, np.int64)
        i = 0
        for n in range(p + 1):
            for m in range(p + 1):
                if m <= n:
                    g[i] = slot[0, m, n]
                    g[i + 1] = slot[1, m, n] if m else -1
                i += 2
        return g, len(g)
    if arrange == SHCArrange.ROW_MAJOR:
        out = []
        for n in range(p + 1):
            for m in range(n + 1):
                out.append(slot[0, m, n])
                out.append(slot[1, m, n] if m else -1)
        return np.asarray(out, np.int64), len(out)
    if arrange == SHCArrange.COL_MAJOR_NONZERO:
        out = []
        for m in range(p + 1):
            out += [slot[0, m, n] for n in range(m, p + 1)]
            if m:
                out += [slot[1, m, n] for n in range(m, p + 1)]
        return np.asarray(out, np.int64), len(out)
    raise ValueError(f"unknown SHCArrange {arrange!r}")


def shc_arrange(shc, p: int, arrange: str):
    """Packed real coefficients (.., (p+1)^2) -> the requested reference
    layout (reference: SHCArrange, sph_harm.hpp:21-36).  A tensor stays
    on its device; a numpy array stays numpy."""
    g, _ = _arrange_maps(p, arrange)
    gi = np.where(g >= 0, g, shc.shape[-1])
    if torch.is_tensor(shc):
        z = torch.zeros(shc.shape[:-1] + (1,), dtype=shc.dtype,
                        device=shc.device)
        return torch.cat([shc, z], dim=-1)[
            ..., torch.as_tensor(gi, device=shc.device)]
    s = np.concatenate([shc, np.zeros(shc.shape[:-1] + (1,),
                                      dtype=shc.dtype)], axis=-1)
    return s[..., gi]


def shc_rearrange(data, p: int, arrange: str):
    """Inverse of `shc_arrange`: layout -> packed real coefficients."""
    g, n = _arrange_maps(p, arrange)
    if data.shape[-1] != n:
        raise ValueError(f"shc_rearrange: {arrange} at p={p} has {n} "
                         f"entries, not {data.shape[-1]}")
    inv = np.full(sh_dim(p), -1, np.int64)
    valid = g >= 0
    inv[g[valid]] = np.where(valid)[0]
    if torch.is_tensor(data):
        return data[..., torch.as_tensor(inv, device=data.device)]
    return data[..., inv]
