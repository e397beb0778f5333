"""ParticleFMM facade, single device (counterpart of
sctl_tpu/fmm/fmm.py:30-185).

Named source and target groups with a source-to-target kernel per pair.
`eval` runs the uniform-tree KIFMM for the six kernels with a tree path
(`_TREE_L2T`) when the target's source groups hold at least
DIRECT_CUTOFF points together, and the direct sum otherwise (below the
cutoff, and always for Stokes3D-FxT and Stokes3D-FxUP), through
`eval_tensor`, the same routes on device tensors (the solver-loop
path); `eval_direct` is the direct-sum oracle.  On the card the direct
sum runs the hand-written `p2p` kernel (ops/direct.py).

`eval_direct_ring` is the distributed direct sum (sctl_tpu/fmm/fmm.py:
186-230; reference: the EvalDirect ring, fmm-wrapper.txx:537-558): over
the facade's comm, each rank holds a shard of the targets and an
equal-sized shard of the sources, and p rounds pass the source shards
around the ring, each round's local sum through `p2p`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..comm.comm import Comm
from ..config import resolve_device
from ..ops.direct import direct_eval_blocked
from ..ops.p2p import p2p
from ..ops.kernels import (KernelSpec, Laplace3D_FxdU, Laplace3D_FxU,
                           Stokes3D_FSxU)
from ..ops.uker import check_supported
from .kifmm import KIFMM

DIRECT_CUTOFF = 40_000   # below this, direct evaluation

# kernels with a tree path and their L2T companion (sctl_tpu/fmm/fmm.py:
# 35-42)
_TREE_L2T = {
    "Laplace3D-FxU": Laplace3D_FxU,
    "Laplace3D-DxU": Laplace3D_FxU,
    "Laplace3D-FxdU": Laplace3D_FxdU,
    "Stokes3D-FxU": Stokes3D_FSxU,
    "Stokes3D-DxU": Stokes3D_FSxU,
    "Stokes3D-FSxU": Stokes3D_FSxU,
}


def fmm_order(accuracy: int) -> int:
    """The KIFMM order p for `accuracy` digits (sctl_tpu/fmm/fmm.py:175)."""
    return max(4, min(10, accuracy))


class _Group:
    def __init__(self):
        self.coord = None
        self.normal = None
        self.density = None
        self.on_device = {}       # coord / normal on the facade's device


class ParticleFMM:
    """fmm = ParticleFMM(comm=None, accuracy=6, device="cuda",
                      dtype=torch.float32)
    fmm.set_kernel_s2t("src", "trg", Stokes3D_DxU)
    fmm.set_src_coord("src", X, normal=N); fmm.set_src_density("src", F)
    fmm.set_trg_coord("trg", Xt)
    U = fmm.eval("trg")          # tree FMM, or direct below the cutoff
    U = fmm.eval_tensor("trg", {"src": F_dev})   # device tensors
    U = fmm.eval_direct("trg")   # O(N^2) oracle

    The tree's depth is KIFMM's default, about 256 points a leaf (depth
    5 at 1e7 points), as the JAX package's facade leaves it, and the
    order p = fmm_order(accuracy).  The routes follow from these by
    data: at accuracy=8 in float32 (p = 8, BASELINE.md's rung 2) the
    Laplace M2L runs the 316-offset grid kernel at levels >= 3, and at
    a few hundred points a leaf the near field runs the halo stencil
    (KIFMM's module docstring); in float64 (rung 4) the M2L runs the
    per-parity sweep, and at that leaf size S2M and L2T the U-list
    kernel.
    """

    def __init__(self, comm: Comm = None, accuracy: int = 6, device=None,
                 dtype: torch.dtype = torch.float32):
        self.comm = comm or Comm.self_()
        self.accuracy = accuracy
        self.device = resolve_device(device)
        self.dtype = dtype
        self.src: Dict[str, _Group] = {}
        self.trg: Dict[str, _Group] = {}
        self.s2t_kernels: Dict[tuple, KernelSpec] = {}
        self._kifmm_cache: Dict[tuple, KIFMM] = {}

    # -- configuration (sctl_tpu/fmm/fmm.py:72-98) -------------------------
    def set_accuracy(self, digits: int):
        self.accuracy = digits
        self._kifmm_cache.clear()

    def add_src(self, name: str):
        self.src.setdefault(name, _Group())

    def add_trg(self, name: str):
        self.trg.setdefault(name, _Group())

    def set_kernel_s2t(self, src: str, trg: str, kernel: KernelSpec):
        check_supported(kernel.name)
        self.add_src(src)
        self.add_trg(trg)
        self.s2t_kernels[(src, trg)] = kernel

    def set_src_coord(self, name: str, X, normal=None):
        self.add_src(name)
        self.src[name].coord = np.asarray(X, np.float64)
        if normal is not None:
            self.src[name].normal = np.asarray(normal, np.float64)
        self.src[name].on_device = {}
        self._kifmm_cache.clear()

    def set_src_density(self, name: str, F):
        self.add_src(name)
        self.src[name].density = np.asarray(F, np.float64)

    def set_trg_coord(self, name: str, X):
        self.add_trg(name)
        self.trg[name].coord = np.asarray(X, np.float64)
        self.trg[name].on_device = {}
        self._kifmm_cache.clear()

    # -- evaluation --------------------------------------------------------
    def eval(self, trg_name: str) -> np.ndarray:
        """Fast evaluation into target group `trg_name`, summed over its
        source groups: `eval_tensor` on the groups' densities, numpy
        out."""
        return self.eval_tensor(trg_name, {
            s: torch.as_tensor(self.src[s].density)
            for (s, t) in self.s2t_kernels if t == trg_name}).cpu().numpy()

    def eval_tensor(self, trg_name: str,
                    densities: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Device-resident evaluation (the counterpart of `eval_jnp`,
        sctl_tpu/fmm/fmm.py:122-150): densities {src_name: (n, k0)
        tensor} on the facade's device -> (n_trg, k1) tensor there, no
        host round trip.  Tree pairs go through KIFMM.eval_tensor, small
        or direct pairs through the blocked direct sum (blocks of 1024 x
        1024 on the CPU).  The coordinates go to the device once and
        stay there."""
        total = sum(len(self.src[s].coord)
                    for (s, t) in self.s2t_kernels if t == trg_name)
        tg = self.trg[trg_name]
        u = None
        for (s, t), ker in self.s2t_kernels.items():
            if t != trg_name:
                continue
            g = self.src[s]
            f = densities[s].to(self.device, self.dtype) \
                .reshape(-1, ker.kdim0)
            if total < DIRECT_CUTOFF or ker.name not in _TREE_L2T:
                us = self._direct_pair(ker, tg, g, f)
            else:
                us = self._get_kifmm(ker, tg.coord, g, s,
                                     trg_name).eval_tensor(f)
            u = us if u is None else u + us
        return u

    def eval_direct(self, trg_name: str) -> np.ndarray:
        """O(N^2) direct evaluation, the correctness oracle."""
        tg = self.trg[trg_name]
        u = None
        for (s, t), ker in self.s2t_kernels.items():
            if t == trg_name:
                g = self.src[s]
                us = self._direct_pair(ker, tg, g, torch.as_tensor(
                    g.density, device=self.device, dtype=self.dtype))
                u = us if u is None else u + us
        return u.cpu().numpy()

    def _direct_pair(self, ker, tg: _Group, g: _Group,
                     f: torch.Tensor) -> torch.Tensor:
        return direct_eval_blocked(
            ker, self._device_copy(tg, "coord"),
            self._device_copy(g, "coord"), f,
            ns=None if g.normal is None else self._device_copy(g, "normal"))

    def _device_copy(self, g: _Group, attr: str) -> torch.Tensor:
        """g's `attr` (coordinates or normals) on the facade's device in
        its dtype, copied once."""
        if attr not in g.on_device:
            g.on_device[attr] = torch.as_tensor(
                getattr(g, attr), device=self.device, dtype=self.dtype)
        return g.on_device[attr]

    def _get_kifmm(self, ker, xt, g, s_name, t_name) -> KIFMM:
        key = (ker.name, s_name, t_name)
        if key not in self._kifmm_cache:
            self._kifmm_cache[key] = KIFMM(
                ker, p=fmm_order(self.accuracy), device=self.device,
                dtype=self.dtype, ker_l2t=_TREE_L2T[ker.name]).setup(
                g.coord, xt, n_src=g.normal)
        return self._kifmm_cache[key]

    # -- distributed direct sum: the ring (fmm-wrapper.txx:537-558) ----------
    def eval_direct_ring(self, kernel: KernelSpec, xt, xs, f, ns=None):
        """Ring direct sum over the facade's comm: xt (T, 3), xs (S, 3), f
        (S, k0) and ns (S, 3) (the double layers only) are this rank's
        shards, tensors on one device, S the same on every rank; returns
        this rank's (T, k1) potentials of all ranks' sources, scale
        included.  p rounds: each adds the local sum of the sources in
        hand through `p2p`, then passes them on with `send_recv_shift`
        (coordinates, normals and densities in one buffer).  On the
        self-communicator: `direct_eval_blocked`."""
        comm = self.comm
        f = f.reshape(xs.shape[0], kernel.kdim0)
        nrm = kernel.needs_normal
        if comm.is_self:
            return direct_eval_blocked(kernel, xt, xs, f,
                                       ns=ns if nrm else None)
        buf = torch.cat([xs, ns if nrm else xs[:, :0], f], dim=1)
        u = None
        for rnd in range(comm.size()):
            xs_c, f_c = buf[:, :3], buf[:, buf.shape[1] - kernel.kdim0:]
            ns_c = buf[:, 3:6] if nrm else None
            us = p2p(kernel, xt, xs_c.contiguous(),
                     None if ns_c is None else ns_c.contiguous(),
                     f_c.contiguous())
            u = us if u is None else u + us
            if rnd < comm.size() - 1:
                buf = comm.send_recv_shift(buf, 1)
        return u * kernel.scale_factor
