"""Cells of the uniform-tree KIFMM (`sctl_tpu_torch.fmm.KIFMM`).

Set-up: the traffic's points from the seed, on the card in float64;
the KIFMM of the configuration set up with those points as sources and
targets; two evaluations on densities of the warm-up stream.  One timed
call is one `eval_tensor` on the next fresh densities of the seed (one
closed-loop caller: the steady state of an outer loop on one particle
set).  The traced run calls the same stages through `_eval_impl` with
a list that collects the program's stage marks.

The check: once the window has closed, the potentials of every
evaluation at the check's sampled targets against the reference's
float64 direct sum of the same densities
(`reference.kernels.direct_sum`), worst relative error over the
evaluations, each error the largest gap over the sampled targets
against the largest reference value.
"""

from __future__ import annotations

import gc

import torch

from .. import generate
from ..reference import kernels as ref
from ..roofline import pairs


class Cell:
    def __init__(self, cfg: dict, trf: dict, seed: int, device):
        from sctl_tpu_torch.fmm import KIFMM
        from sctl_tpu_torch.ops.kernels import KERNELS
        self.cfg, self.trf, self.seed = cfg, trf, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.k0, self.k1 = ref.DIMS[cfg["kernel"]]
        self.x = generate.points(trf["points"], seed, self.device)
        self.n = self.x.shape[0]
        xs = self.x.cpu().numpy()
        self.kf = KIFMM(KERNELS[cfg["kernel"]], p=cfg["p"],
                        depth=cfg["depth"], device=self.device,
                        dtype=self.dtype).setup(xs, xs)
        self.idx = torch.as_tensor(generate.sample(
            seed, self.n, trf["check"]["targets"]), device=self.device)
        # warm-up: two evaluations and what keeps them
        for i in range(2):
            self._reset()
            f = self._density("warm", i)
            self.keep(i, f, self.call(f, None))
        self._reset()

    def _reset(self):
        self.samples = []
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)

    def _density(self, stream: str, i: int):
        return generate.densities(self.trf["densities"], self.seed, stream,
                                  i, self.n, self.k0, self.device,
                                  self.dtype)

    def prepare(self, i: int):
        return self._density("density", i)

    def call(self, f, marks):
        kf = self.kf
        if marks is None:
            return kf.eval_tensor(f)
        fp, fo = kf.pad_density(f)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        m = [("start", ev)]
        u = kf.unsort(*kf._eval_impl(fp, fo, m))
        marks.append(m)
        return u

    def keep(self, i: int, f, u) -> None:
        self.samples.append(u[self.idx].reshape(-1, self.k1).clone())
        self.bad += (~torch.isfinite(u)).any().long()

    def failed(self) -> int:
        """Evaluations that gave a value that is not finite."""
        return int(self.bad)

    def release(self) -> None:
        self.kf = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, times, window_s: float) -> dict:
        from ..stats import percentile
        return {"points_per_s": len(times) * self.n / window_s,
                "eval_ms_p95": 1e3 * percentile(times, 95)}

    def checks(self) -> list:
        """[(name, value, limit)] of the check (see the module
        docstring)."""
        lim = self.cfg["limits"]
        n = len(self.samples)
        chunk = max(1, int(self.trf["check"]["density_bytes"]
                           // (8 * self.n * self.k0)))
        xt = self.x[self.idx]
        worst = 0.0
        for c in range(0, n, chunk):
            ids = range(c, min(n, c + chunk))
            F = torch.stack([self._density("density", i).double()
                             for i in ids], -1)
            r = ref.direct_sum(self.cfg["kernel"], xt, self.x, F)
            del F
            for j, i in enumerate(ids):
                u = self.samples[i].double()
                rj = r[..., j]
                err = float((u - rj).abs().max() / rj.abs().max())
                worst = max(worst, err) if err == err else float("inf")
        return [("rel_err", worst, lim["rel_err"])]

    def layer_data(self) -> dict:
        w = pairs.uniform_fmm_work(self.x, self.cfg["depth"], self.cfg["p"],
                                   self.cfg["kernel"], self.k0, self.k1)
        return {"work": w}
