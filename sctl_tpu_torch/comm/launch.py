"""Run a function on several rank processes (the port's own: a JAX mesh
needs no processes).

    results = run_ranks(fn, 4, x, backend="gloo", device="cpu")

spawns `world_size` processes with `torch.multiprocessing` (the spawn
start method).  Each caps its CPU thread pools at `threads` (OpenMP and
the BLAS pools by the environment it starts with, torch's intra-op pool
by `torch.set_num_threads`; `config.limit_cpu_threads` needs
threadpoolctl, which a card's host may lack), joins one process group
through a `FileStore` in a temporary directory of its own (so that
concurrent runs never share a port), and calls fn(comm, *args) with
`comm = Comm.world()`; on a CUDA device each rank selects it before the
group starts (ranks may share one card).  fn must be importable from
its module (it is pickled by name), and so must its arguments; the two
reach the ranks through a file in that directory, not the spawn pipe,
so that a rank that dies while it starts cannot leave the parent
blocked on a pipe no one reads.

Each rank's result comes back to the caller, tensors as numpy arrays
(dicts, lists and tuples kept), in rank order.  The parent joins under a
deadline: a rank that exits non-zero, or a run that overruns, kills the
other ranks and raises with the failed rank's traceback.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch

DEFAULT_TIMEOUT = 600.0
# the thread pools' environment variables a rank starts with
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, world_size, tmpdir, backend, device, threads):
    import torch.distributed as dist
    from .comm import Comm
    out = os.path.join(tmpdir, f"rank{rank}.pkl")
    try:
        with open(os.path.join(tmpdir, "job.pkl"), "rb") as fh:
            fn, args = pickle.load(fh)
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0 if dev.index is None else dev.index)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmpdir, "store"),
                                          world_size),
            rank=rank, world_size=world_size)
        try:
            res = _to_host(fn(Comm.world(), *args))
        finally:
            dist.destroy_process_group()
        with open(out + ".tmp", "wb") as fh:
            pickle.dump(res, fh)
        os.replace(out + ".tmp", out)
    except BaseException:
        with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


class RankGroup:
    """Rank processes started by `start_ranks`; `join()` waits for them
    and returns their results."""

    def __init__(self, fn, world_size: int, args, backend: str, device,
                 timeout: float, threads: int):
        ctx = torch.multiprocessing.get_context("spawn")
        self.tmpdir = tempfile.mkdtemp(prefix="sctl_ranks_")
        self.world_size = world_size
        self.timeout = timeout
        self.t0 = time.monotonic()
        dev = str(torch.device("cuda" if device is None else device))
        with open(os.path.join(self.tmpdir, "job.pkl"), "wb") as fh:
            pickle.dump((fn, args), fh)
        self.procs = [ctx.Process(
            target=_rank_main,
            args=(r, world_size, self.tmpdir, backend, dev, threads),
            daemon=True) for r in range(world_size)]
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: str(threads) for k in _THREAD_VARS})
        try:
            for p in self.procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    def _kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)

    def _failure(self, rank: int, why: str) -> RuntimeError:
        """The error of the rank whose traceback was written first (the
        others' are often the broken connections it left), else of
        `rank`."""
        errs = [(os.path.getmtime(e), r, e) for r in range(self.world_size)
                for e in [os.path.join(self.tmpdir, f"rank{r}.err")]
                if os.path.exists(e)]
        if errs:
            _, first, path = min(errs)
            if first != rank:
                why = f"failed first (rank {rank} {why})"
            rank, tb = first, open(path).read()
        else:
            tb = "(no traceback)"
        return RuntimeError(f"rank {rank} of {self.world_size} {why}:\n{tb}")

    def join(self) -> list:
        try:
            while True:
                codes = [p.exitcode for p in self.procs]
                bad = [r for r, c in enumerate(codes)
                       if c is not None and c != 0]
                if bad:
                    self._kill()
                    raise self._failure(bad[0],
                                        f"exited with code {codes[bad[0]]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() - self.t0 > self.timeout:
                    late = codes.index(None)
                    self._kill()
                    raise self._failure(late, f"overran the {self.timeout:g}"
                                        " s deadline")
                time.sleep(0.05)
            out = []
            for r in range(self.world_size):
                with open(os.path.join(self.tmpdir, f"rank{r}.pkl"),
                          "rb") as fh:
                    out.append(pickle.load(fh))
            return out
        finally:
            self._kill()
            shutil.rmtree(self.tmpdir, ignore_errors=True)


def start_ranks(fn, world_size: int, *args, backend: str = "gloo",
                device=None, timeout: float = DEFAULT_TIMEOUT,
                threads: int = 2) -> RankGroup:
    """Start the rank processes of `run_ranks` and return at once; the
    group's `join()` gives the results.  device: the ranks' device,
    default the card."""
    return RankGroup(fn, world_size, args, backend, device, timeout,
                     threads)


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              device=None, timeout: float = DEFAULT_TIMEOUT,
              threads: int = 2) -> list:
    """fn(comm, *args) on `world_size` rank processes -> each rank's
    result, tensors as numpy, in rank order (see the module
    docstring)."""
    return start_ranks(fn, world_size, *args, backend=backend,
                       device=device, timeout=timeout,
                       threads=threads).join()
