"""Near-singular quadrature assembly on the device (counterpart of
sctl_tpu/bie/near_device.py:60-678).

The rule descriptors (Gauss-Newton preimages, shell-radii ladders, band
classes) are built on the host; every floating-point-heavy stage
(panelization, geometry, kernel blocks, basis contractions, the
far-quadrature subtraction) runs in torch on the op's device, and the
result stays there for the operator apply.

float32 accuracy: every displacement is formed in a local frame.
Ladder bands and the far subtraction use element-centred coordinates;
Duffy shells use parameter offsets built from the shell radii and the
exact-difference chart dX = X(u0 + delta) - X(u0) (`DeviceGeom.delta`),
with the target entering as r0 = xt - X(u0), computed on the host in
float64.

The engine needs one element list with a `device_geom`;
BoundaryIntegralOp takes the host path (float64 numpy) otherwise.  A
pair whose preimage fails or that neither Duffy order nor the escalation
rung resolves goes, as in the JAX package, to the element list's
per-pair host rule (Duffy, then adaptive subdivision, in float64),
all such pairs in one batch; their count is returned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.quadrule import leg_quad_rule
from ..ops.kernels_np import block_matrix_np
from ..ops.uker import uker_matrix
from .legacy_quadrature import duffy_radii_batch

__all__ = ["DeviceGeom", "TorusGeom", "SphereGeom", "assemble_near_device"]


class DeviceGeom:
    """Exact-difference chart protocol of the Duffy stage.

    delta(eids (C,), u0 (C, 2), duv (C, M, 2)) -> (dX (C, M, 3), n
    (C, M, 3), J (C, M)): the displacement X(u0 + duv) - X(u0), the
    outward unit normal and the surface Jacobian at u0 + duv, computed
    so that small |duv| keeps full relative precision in dX."""

    def delta(self, eids, u0, duv):
        raise NotImplementedError


def _dcos(a0, da):
    """cos(a0 + da) - cos(a0) without cancellation."""
    return -2.0 * torch.sin(0.5 * da) * torch.sin(a0 + 0.5 * da)


def _dsin(a0, da):
    """sin(a0 + da) - sin(a0) without cancellation."""
    return 2.0 * torch.sin(0.5 * da) * torch.cos(a0 + 0.5 * da)


class TorusGeom(DeviceGeom):
    """Torus (major R, minor r) in nu x nv patches, the chart of
    patches.torus_patches with analytic normals and Jacobian."""

    def __init__(self, nu, nv, R, r, flip=1.0):
        self.nu, self.nv, self.R, self.r = nu, nv, R, r
        self.flip = flip

    def delta(self, eids, u0, duv):
        nu, nv, R, r = self.nu, self.nv, self.R, self.r
        dt = duv.dtype
        two_pi = 2 * np.pi
        eu = torch.div(eids, nv, rounding_mode="floor").to(dt)
        ev = (eids % nv).to(dt)
        th0 = (two_pi * (eu + u0[:, 0]) / nu)[:, None]
        ph0 = (two_pi * (ev + u0[:, 1]) / nv)[:, None]
        dth = two_pi * duv[..., 0] / nu
        dph = two_pi * duv[..., 1] / nv
        th1 = th0 + dth
        dcph = _dcos(ph0, dph)
        w0 = R + r * torch.cos(ph0)
        dX = torch.stack([w0 * _dcos(th0, dth) + r * dcph * torch.cos(th1),
                          w0 * _dsin(th0, dth) + r * dcph * torch.sin(th1),
                          r * _dsin(ph0, dph)], -1)
        ph1 = ph0 + dph
        cph1, sph1 = torch.cos(ph1), torch.sin(ph1)
        n = self.flip * torch.stack([cph1 * torch.cos(th1),
                                     cph1 * torch.sin(th1), sph1], -1)
        J = (two_pi / nu) * (two_pi / nv) * r * (R + r * cph1)
        return dX, n, J


class SphereGeom(DeviceGeom):
    """Cubed-sphere charts (patches.sphere_patches): X = radius p/|p|
    with p affine in the patch parameters, in the exact-difference form

      X1 - X0 = radius [A d / |p1| + p0 (|p0|^2 - |p1|^2)
                        / (|p0| |p1| (|p0| + |p1|))],
      |p0|^2 - |p1|^2 = -(2 p0.(A d) + |A d|^2)."""

    def __init__(self, n_per_face, radius, axes, flip=1.0):
        self.n = n_per_face
        self.radius = radius
        self.ax = np.asarray([(a, b, c) for (a, b, c, _) in axes])
        self.sgn = np.asarray([s for (_, _, _, s) in axes], np.float64)
        self.flip = flip

    def _p0_A(self, eids, u0):
        n = self.n
        f = torch.div(eids, n * n, rounding_mode="floor")
        w = eids % (n * n)
        h = 1.0 / n
        dt, dev = u0.dtype, u0.device
        uu = (torch.div(w, n, rounding_mode="floor") * h
              + u0[:, 0] * h) * 2 - 1
        vv = ((w % n) * h + u0[:, 1] * h) * 2 - 1
        C = len(eids)
        rows = torch.arange(C, device=dev)
        ax = torch.as_tensor(self.ax, device=dev)
        a, b, c = ax[f, 0], ax[f, 1], ax[f, 2]
        sg = torch.as_tensor(self.sgn, dtype=dt, device=dev)[f]
        p0 = torch.zeros((C, 3), dtype=dt, device=dev)
        p0[rows, a] = uu.to(dt)
        p0[rows, b] = (vv * sg).to(dt)
        p0[rows, c] = sg
        A = torch.zeros((C, 3, 2), dtype=dt, device=dev)
        A[rows, a, 0] = 2 * h
        A[rows, b, 1] = 2 * h * sg
        return p0, A

    def delta(self, eids, u0, duv):
        rad = self.radius
        p0, A = self._p0_A(eids, u0)
        Ad = torch.einsum("cij,cmj->cmi", A, duv)
        p0_ = p0[:, None, :]
        r0 = torch.sqrt((p0_ * p0_).sum(-1))
        p1 = p0_ + Ad
        r1 = torch.sqrt((p1 * p1).sum(-1))
        num = -(2.0 * (p0_ * Ad).sum(-1) + (Ad * Ad).sum(-1))
        dX = rad * (Ad / r1[..., None]
                    + p0_ * (num / (r0 * r1 * (r0 + r1)))[..., None])
        n = self.flip * p1 / r1[..., None]
        a0, a1 = A[:, None, :, 0], A[:, None, :, 1]
        tu = a0 - n * (n * a0).sum(-1, keepdim=True)
        tv = a1 - n * (n * a1).sum(-1, keepdim=True)
        cr = torch.cross(tu, tv, dim=-1)
        J = (rad / r1) ** 2 * torch.sqrt((cr * cr).sum(-1))
        return dX, n, J


# -- helpers -------------------------------------------------------------------

def _uv_rule(order):
    x1, w1 = leg_quad_rule(order)
    uv = np.stack(np.meshgrid(x1, x1, indexing="ij"), -1).reshape(-1, 2)
    return uv, np.outer(w1, w1).reshape(-1)


def _basis_dev(x1_np, uv, dtype):
    """Tensor Lagrange basis on the device, uv (..., 2) -> (..., q^2):
    first-form barycentric with a tiny-denominator guard and the
    one-hot row at an exact node hit."""
    dev = uv.device
    x1 = torch.as_tensor(x1_np, dtype=dtype, device=dev)
    den = x1_np[:, None] - x1_np[None, :]
    np.fill_diagonal(den, 1.0)
    w = torch.as_tensor(1.0 / den.prod(axis=1), dtype=dtype, device=dev)
    tiny = 1e-30 if dtype == torch.float64 else 1e-18

    def axis(t):
        d = t[..., None] - x1
        hit = d == 0.0
        m = (d.prod(-1)[..., None] * w
             / torch.where(d.abs() < tiny, torch.full_like(d, tiny), d))
        return torch.where(hit.any(-1, keepdim=True), hit.to(dtype), m)

    mu, mv = axis(uv[..., 0]), axis(uv[..., 1])
    return (mu[..., :, None] * mv[..., None, :]).reshape(
        uv.shape[:-1] + (len(x1_np) ** 2,))


def _blocks(kname: str, scale: float, d, ns):
    """Kernel blocks (..., k0, k1) with the scale factor; r below a
    dtype-dependent floor counts as coincident."""
    r2 = (d * d).sum(-1)
    tiny = 1e-280 if d.dtype == torch.float64 else 1e-30
    pos = r2 > tiny
    safe = torch.where(pos, r2, torch.ones_like(r2))
    rinv = torch.where(pos, 1.0 / torch.sqrt(safe)
                       if d.dtype == torch.float64 else torch.rsqrt(safe),
                       torch.zeros_like(r2))
    return uker_matrix(kname, d, rinv, ns) * scale


def _seg_matmul(bw, blk, seg: int = 512):
    """(C, nq, M) @ (C, M, k) with the M contraction split into
    `seg`-sized partial products summed at the end: bounds the float32
    rounding of long sums (sctl_tpu near_device._seg_matmul)."""
    C, nq, M = bw.shape
    nseg = -(-M // seg)
    if nseg <= 1:
        return torch.matmul(bw, blk)
    pad = nseg * seg - M
    if pad:
        bw = torch.nn.functional.pad(bw, (0, pad))
        blk = torch.nn.functional.pad(blk, (0, 0, 0, pad))
    bw = bw.reshape(C, nq, nseg, seg).transpose(1, 2)
    blk = blk.reshape(C, nseg, seg, blk.shape[-1])
    return torch.matmul(bw, blk).sum(1)


def _pad_idx(idx, C, fill):
    out = np.full(C, fill, np.int64)
    out[:len(idx)] = idx
    return out


def _pad_rows_f(a, C):
    out = np.zeros((C,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out


# -- the engine ------------------------------------------------------------------

def assemble_near_device(op, chunk_scale: float = 1.0):
    """op's near-correction matrices K_near(t, e) - K_far(t, e) on
    op.device in op.dtype: a (P, nq*k0, k1) tensor, pairs ordered as
    op.near_pairs, and the number of pairs that took the per-pair host
    rule.  Needs one ParametricPatchList with a `device_geom` and
    uniform node and far-node counts per element.  Stage seconds (host
    clock, the device fenced after each stage) go to op._near_prof."""
    import time
    prof = {}
    t_last = [time.perf_counter()]
    dev, dtype = op.device, op.dtype
    np_dt = np.float64 if dtype == torch.float64 else np.float32

    def tick(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        prof[name] = prof.get(name, 0.0) + t - t_last[0]
        t_last[0] = t

    def put(a, dt=None):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    lst = op.elem_lists[0]
    geom = getattr(lst, "device_geom", None)
    if len(op.elem_lists) != 1 or geom is None:
        raise NotImplementedError(
            "the device near engine needs one element list with a "
            "device_geom; use_device_near=False (or None) takes the host "
            "path")
    ker = op.kernel
    k0, k1 = ker.kdim0, ker.kdim1
    nq, nf = lst.q ** 2, lst.qf ** 2
    pair_t = np.array([t for (t, _) in op.near_pairs], np.int64)
    pair_e = np.array([e for (_, e) in op.near_pairs], np.int64)
    P = len(pair_t)
    out = torch.zeros((P + 1, nq, k0 * k1), dtype=dtype, device=dev)
    if P == 0:
        op._near_prof = prof
        return out[:0].reshape(0, nq * k0, k1), 0
    Xt, tol = op.Xt_eff, op.tol
    kname, kscale = ker.name, float(ker.scale_factor)

    # -- host: preimages and bands (the GL error model of dist_far) ----
    u0, adapt, dphys, ok = lst._preimage_batch(Xt[pair_t], pair_e)
    tick("preimage")
    X_all = lst._node_X_all()
    diam = np.linalg.norm(X_all.max(1) - X_all.min(1), axis=1)
    orders = [m * lst.qf for m in lst._LADDER]
    band = np.full(P, -1, np.int64)
    for k in range(len(orders) - 1, -1, -1):
        dk = (2.0 * (diam[pair_e] / orders[k])
              * (0.1 * tol) ** (-1.0 / orders[k]))
        band = np.where(dphys >= dk, k, band)
    band = np.where(ok, band, -2)
    ctr = X_all.mean(1)
    Xt_loc = Xt[pair_t] - ctr[pair_e]              # element-centred
    E = lst.size()

    # -- ladder bands: shared tensor rules, padded to one width -------
    bands = [(k, orders[k], np.where(band == k)[0])
             for k in range(len(orders))]
    bands = [b for b in bands if len(b[2])]
    if bands:
        S_pad = max(qk * qk for _, qk, _ in bands)
        C = max(64, int(chunk_scale * 8.0e6) // S_pad)
        for k, qk, idx in bands:
            uv, ww = _uv_rule(qk)
            S = len(ww)
            ue = np.unique(pair_e[idx])
            Xg, ng, Jg = lst._geom_many(np.repeat(ue, S),
                                        np.tile(uv, (len(ue), 1)))
            Xg_p = np.full((E, S_pad, 3), 1e3)
            Xg_p[ue, :S] = Xg.reshape(len(ue), S, 3) - ctr[ue][:, None, :]
            ng_p = np.zeros((E, S_pad, 3))
            ng_p[ue, :S] = ng.reshape(len(ue), S, 3)
            wJ_p = np.zeros((E, S_pad))
            wJ_p[ue, :S] = ww[None, :] * Jg.reshape(len(ue), S)
            bas_p = np.zeros((nq, S_pad))
            bas_p[:, :S] = lst._basis(uv).T
            dXg, dng = put(Xg_p, dtype), put(ng_p, dtype)
            dwJ, dbas = put(wJ_p, dtype), put(bas_p, dtype)
            for c0 in range(0, len(idx), C):
                sl = idx[c0:c0 + C]
                ip = put(pair_e[sl])
                d = put(Xt_loc[sl], dtype)[:, None, :] - dXg[ip]
                blk = _blocks(kname, kscale, d, dng[ip])
                bw = dbas[None] * dwJ[ip][:, None, :]
                out[put(sl)] = _seg_matmul(
                    bw, blk.reshape(len(sl), S_pad, -1))
            tick(f"ladder_b{k}")

    # -- Duffy singular class, two orders, then +8 on disagreement ----
    didx = np.where(band == -1)[0]
    miss = np.zeros(P, bool)
    if len(didx):
        r0vec = Xt[pair_t[didx]] - lst._xyz_many(pair_e[didx], u0[didx])
        order_hi, order_lo = (16, 12) if tol >= 1e-7 else (24, 18)
        met = torch.zeros((2, P + 1), dtype=dtype, device=dev)
        sweep = (lambda sel, r0, order, mode: _duffy_sweep(
            lst, geom, ker, sel, pair_e, u0, adapt, r0, order, out, met,
            mode, chunk_scale))
        sweep(didx, r0vec, order_hi, "set")
        sweep(didx, r0vec, order_lo, "cmp")
        met_h = met.cpu().numpy()
        tick("duffy")
        scale = np.maximum(met_h[0, didx], 1e-300)
        retry = didx[met_h[1, didx] > 30 * tol * scale]
        prof["duffy_retry_n"] = len(retry)
        if len(retry):
            r0r = Xt[pair_t[retry]] - lst._xyz_many(pair_e[retry],
                                                    u0[retry])
            sweep(retry, r0r, order_hi + 8, "cmpset")
            met_h = met.cpu().numpy()
            s2 = np.maximum(met_h[0, retry], 1e-300)
            # float32 noise floor of the pipeline's own arithmetic (the
            # JAX package's 1e-4): below it the two orders' difference
            # says nothing about the quadrature's convergence
            floor = 1e-4 if dtype == torch.float32 else 0.0
            miss[retry[met_h[1, retry]
                       > np.maximum(30 * tol, floor) * s2]] = True
            tick("duffy_escalation")

    # -- far-quadrature subtraction, all pairs ------------------------
    dXf = put((op.Xf.reshape(E, nf, 3) - ctr[:, None, :]), dtype)
    dnf = put(op.Xnf.reshape(E, nf, 3), dtype)
    dwf = put(op.wf.reshape(E, nf), dtype)
    dinterp = put(lst.far_field_density_matrix(0), dtype)   # (nq, nf)
    Cf = max(256, int(chunk_scale * 8.0e6) // nf)
    for c0 in range(0, P, Cf):
        sl = np.arange(c0, min(c0 + Cf, P))
        pe = put(pair_e[sl])
        d = put(Xt_loc[sl], dtype)[:, None, :] - dXf[pe]
        blk = _blocks(kname, kscale, d, dnf[pe]) * dwf[pe][..., None, None]
        out[put(sl)] -= torch.einsum("nf,cfk->cnk", dinterp,
                                     blk.reshape(len(sl), nf, -1))
    tick("far")

    # -- the per-pair host rule for preimage failures and Duffy misses --
    fb = np.where((band == -2) | miss)[0]
    prof["fallback_n"] = len(fb)
    if len(fb):
        m = lst._near_interac_pairs(ker, Xt[pair_t[fb]], pair_e[fb], tol)
        interp = lst.far_field_density_matrix(0)
        vals = np.zeros((len(fb), nq, k0 * k1))
        for j, pi in enumerate(fb):
            e, xt = int(pair_e[pi]), Xt[pair_t[pi]]
            s, t = op.far_dsp[e], op.far_dsp[e + 1]
            kf = (block_matrix_np(ker, xt[None], op.Xf[s:t], op.Xnf[s:t])
                  * op.wf[None, s:t, None, None])
            far = np.tensordot(kf, interp, axes=([1], [1]))[0]
            vals[j] = (m[j].reshape(nq, k0, k1)
                       - far.transpose(2, 0, 1)).reshape(nq, k0 * k1)
        out[put(fb)] = put(vals, dtype)
        tick("fallback")
    op._near_prof = prof
    return out[:P].reshape(P, nq * k0, k1), len(fb)


def _duffy_sweep(lst, geom, ker, didx, pair_e, u0, adapt, r0vec, order,
                 out, met, mode, chunk_scale):
    """One Duffy order over the given singular pairs, written into out
    and the per-pair metrics met in place.

    mode: "set"    out[p] = v, met[0, p] = max |v|;
          "cmp"    met[1, p] = max |v - out[p]| (out unchanged);
          "cmpset" both (the escalation rung)."""
    dev, dt = out.device, out.dtype
    radii = duffy_radii_batch(u0[didx], order,
                              np.where(adapt[didx] < 1e-7, 0.0,
                                       adapt[didx]))
    K = -(-(radii.shape[1] - 1) // 2) * 2
    radii = np.pad(radii, ((0, 0), (0, K + 1 - radii.shape[1])),
                   mode="edge")
    C = max(32, int(chunk_scale * 4.0e6) // (K * 4 * order * order))
    put = lambda a, t=None: torch.as_tensor(np.asarray(a), dtype=t,
                                            device=dev)
    for c0 in range(0, len(didx), C):
        sl = slice(c0, c0 + C)
        sel = put(didx[sl])
        v = _duffy_chunk(put(u0[didx[sl]], dt), put(radii[sl], dt),
                         put(r0vec[sl], dt), put(pair_e[didx[sl]]),
                         ker, geom, order, lst._x1)
        n = v.shape[0]
        if mode in ("cmp", "cmpset"):
            met[1, sel] = (v - out[sel]).abs().reshape(n, -1).amax(1)
        if mode in ("set", "cmpset"):
            out[sel] = v
            met[0, sel] = v.abs().reshape(n, -1).amax(1)


def _duffy_chunk(c, rad, r0, eid, ker, geom, order, x1):
    """One Duffy chunk: c (C, 2) preimages, rad (C, K+1) shell ladders,
    r0 (C, 3) = xt - X(u0), eid (C,) elements -> (C, nq, k0*k1).

    The panelization is the device form of duffy_quad_batch's panel
    blend, in local parameter offsets."""
    dt, dev = c.dtype, c.device
    K = rad.shape[1] - 1
    q1, w1 = leg_quad_rule(order)
    yy, zz = np.meshgrid(q1, q1, indexing="ij")
    n2 = order * order
    y = torch.as_tensor(yy.ravel(), dtype=dt, device=dev)[None, None, :]
    z = torch.as_tensor(zz.ravel(), dtype=dt, device=dev)[None, None, :]
    ww = torch.as_tensor(np.outer(w1, w1).ravel(), dtype=dt, device=dev)
    eps = 16 * np.finfo(np.float64).eps     # panels thinner carry no weight
    r0_, r1_ = rad[:, :-1], rad[:, 1:]

    def clip_lo(v, c_):                      # clip(c + v) - c, locally
        return torch.minimum(torch.maximum(v, -c_), 1.0 - c_)

    duv, wts = [], []
    for d0 in range(2):
        cd0 = c[:, d0][:, None]
        cd1 = c[:, 1 - d0][:, None]
        for sgn in (-1.0, 1.0):
            f0, f1 = clip_lo(sgn * r0_, cd0), clip_lo(sgn * r1_, cd0)
            lo0, hi0 = clip_lo(-r0_, cd1), clip_lo(r0_, cd1)
            lo1, hi1 = clip_lo(-r1_, cd1), clip_lo(r1_, cd1)
            th = (f1 - f0).abs()
            w0, w1_ = hi0 - lo0, hi1 - lo1
            live = (th * torch.maximum(w0, w1_) >= eps).to(dt)
            dd0 = f0[..., None] * (1 - z) + f1[..., None] * z
            dd1 = ((lo0[..., None] * (1 - y) + hi0[..., None] * y) * (1 - z)
                   + (lo1[..., None] * (1 - y) + hi1[..., None] * y) * z)
            duv.append(torch.stack([dd0, dd1], -1) if d0 == 0
                       else torch.stack([dd1, dd0], -1))  # (C, K, n2, 2)
            wts.append(live[..., None] * ww * th[..., None]
                       * (w0[..., None] * (1 - z) + w1_[..., None] * z))
    duv = torch.stack(duv, 2).reshape(-1, K * 4 * n2, 2)
    wt = torch.stack(wts, 2).reshape(-1, K * 4 * n2)
    dX, n, J = geom.delta(eid, c, duv)
    d = r0[:, None, :] - dX
    blk = _blocks(ker.name, float(ker.scale_factor), d, n)
    basis = _basis_dev(np.asarray(x1, np.float64), c[:, None, :] + duv, dt)
    bw = basis * (wt * J)[..., None]
    return _seg_matmul(bw.transpose(1, 2),
                       blk.reshape(blk.shape[0], -1, ker.kdim0 * ker.kdim1))
