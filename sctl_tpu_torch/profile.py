"""Profiler: Tic/Toc blocks, counters and the expression-DSL report
(counterpart of sctl_tpu/profile.py; reference:
include/sctl/profile.hpp:21-202, profile.txx:250-533).

A global store of named counters (TIME, FLOP, communication messages
and bytes, custom), an event log of Tic/Toc blocks with counter
snapshots, and a report that evaluates named fields such as ``f/s``
over each block's counter deltas.

Where it differs from the JAX package:
  - TIME is the host's wall clock.  `sync=True` waits for the card
    (`torch.cuda.synchronize()` on the device in use, the counterpart
    of `_sync_devices`); the library's own blocks (KIFMM::Eval,
    AdaptiveFMM::Eval, BIO::ComputePotential, GMRES) pass it, since a
    CUDA launch returns before its work ends and a block that does not
    wait times the launch queue.  A block that records nothing (its
    level above `config.profile_level`) does not wait either.
  - FLOPs are credited by the callers from their cost models
    (`add_flops`), as in the JAX package.  Eager PyTorch has no traced
    region, so every credit increments the counters at once (the JAX
    package's path outside a trace, sctl_tpu/profile.py:268-288).
  - `device_trace(logdir)` records a `torch.profiler` trace into
    `logdir`; `xla_cost(fn, *args)` counts with
    `torch.utils.flop_counter.FlopCounterMode` (see its docstring).
  - One process drives the card: `_process_gather` returns [v] until
    the distributed slice brings a process group.

The gate SCTL_PROFILE=<level> is `config.profile_level` (default -1,
every block off): blocks deeper than the level are skipped
(profile.txx:529-533).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from . import config

# Counter names mirror profile.hpp:21-38.
COUNTERS = (
    "TIME", "FLOP",
    "ALLOC_COUNT", "ALLOC_BYTES", "FREE_COUNT", "FREE_BYTES",
    "COMM_COUNT", "COMM_BYTES", "COLL_COUNT", "COLL_BYTES",
    "CUSTOM0", "CUSTOM1", "CUSTOM2", "CUSTOM3", "CUSTOM4",
)


@dataclass
class _Block:
    name: str
    depth: int
    t_start: float
    snapshot: Dict[str, float]
    t_stop: Optional[float] = None
    snapshot_stop: Optional[Dict[str, float]] = None
    children: List["_Block"] = field(default_factory=list)


class _ProfileData:
    def __init__(self):
        self.counters: Dict[str, float] = {c: 0.0 for c in COUNTERS}
        self.root = _Block("root", -1, time.perf_counter(),
                           dict(self.counters))
        self.stack: List[_Block] = [self.root]
        self.enabled = True
        # expression DSL fields: name -> fn(delta_counters, dt) -> value
        self.fields: Dict[str, Callable] = {}

    def reset(self):
        self.__init__()


_data = _ProfileData()


class Profile:
    """Static facade, mirroring the reference's `Profile` class API."""

    @staticmethod
    def reset():
        _data.reset()

    @staticmethod
    def enable(flag: bool = True):
        _data.enabled = flag

    @staticmethod
    def increment_counter(name: str, value: float):
        _data.counters[name] = _data.counters.get(name, 0.0) + value

    @staticmethod
    def get_counter(name: str) -> float:
        return _data.counters.get(name, 0.0)

    @staticmethod
    def tic(name: str, sync: bool = False, level: int = 0):
        """Open a named timing block (profile.hpp:72).  sync=True waits
        for the card's queued work first, so the block times only its
        own."""
        if not _data.enabled or level > config.profile_level:
            return
        if sync:
            _sync_devices()
        if config.verbose:
            print("  " * len(_data.stack) + f"[prof] {name}")
        blk = _Block(name, len(_data.stack) - 1, time.perf_counter(),
                     dict(_data.counters))
        _data.stack[-1].children.append(blk)
        _data.stack.append(blk)

    @staticmethod
    def toc(sync: bool = False):
        if not _data.enabled or len(_data.stack) <= 1:
            return
        if sync:
            _sync_devices()
        blk = _data.stack.pop()
        blk.t_stop = time.perf_counter()
        blk.snapshot_stop = dict(_data.counters)

    @staticmethod
    @contextlib.contextmanager
    def scoped(name: str, sync: bool = False, level: int = 0):
        """RAII block (reference: Profile::Scoped, profile.hpp:82-100)."""
        active = _data.enabled and level <= config.profile_level
        if active:
            Profile.tic(name, sync=sync, level=level)
        try:
            yield
        finally:
            if active:
                Profile.toc(sync=sync)

    @staticmethod
    def set_prof_field(name: str, fn: Callable):
        """Register a custom report column: fn(deltas, dt) -> float
        (reference: SetProfField, profile.hpp:143)."""
        _data.fields[name] = fn

    @staticmethod
    def print_report(fields=("t", "f", "f/s", "comm_bytes"),
                     out=None) -> str:
        """Walk the block tree and print each block's counter-delta
        fields: t (seconds), f (GFLOP), f/s (GFLOP/s), comm_bytes, the
        reductions over processes t_min, t_max, t_avg, f_total,
        f/s_total (profile.txx:293-304), a field registered with
        `set_prof_field`, or a counter's name."""
        lines = []
        header = f"{'block':40s}" + "".join(f"{f:>14s}" for f in fields)
        lines.append(header)
        lines.append("-" * len(header))

        def field_value(fname, deltas, dt):
            if fname == "t":
                return dt
            if fname == "f":
                return deltas.get("FLOP", 0.0) / 1e9
            if fname == "f/s":
                return deltas.get("FLOP", 0.0) / 1e9 / max(dt, 1e-12)
            if fname == "comm_bytes":
                return (deltas.get("COMM_BYTES", 0.0)
                        + deltas.get("COLL_BYTES", 0.0))
            if fname in ("t_min", "t_max", "t_avg", "f_total",
                         "f/s_total"):
                base = (dt if fname.startswith("t_")
                        else deltas.get("FLOP", 0.0) / 1e9)
                vals = _process_gather(base)
                if fname == "t_min":
                    return min(vals)
                if fname == "t_max":
                    return max(vals)
                if fname == "t_avg":
                    return sum(vals) / len(vals)
                if fname == "f_total":
                    return sum(vals)
                return sum(vals) / max(dt, 1e-12)
            if fname in _data.fields:
                return _data.fields[fname](deltas, dt)
            return deltas.get(fname, 0.0)

        def walk(blk: _Block, indent: int):
            if blk.name != "root":
                t_stop = blk.t_stop or time.perf_counter()
                snap_stop = blk.snapshot_stop or _data.counters
                dt = t_stop - blk.t_start
                deltas = {k: snap_stop.get(k, 0.0) - blk.snapshot.get(k, 0.0)
                          for k in snap_stop}
                label = ("  " * indent + blk.name)[:40]
                row = f"{label:40s}" + "".join(
                    f"{field_value(f, deltas, dt):>14.6g}" for f in fields)
                lines.append(row)
            for c in blk.children:
                walk(c, indent + (0 if blk.name == "root" else 1))

        walk(_data.root, 0)
        report = "\n".join(lines)
        if out is None:
            print(report)
        else:
            out.write(report)
        return report

    @staticmethod
    def xla_cost(fn, *args) -> dict:
        """{"flops", "bytes"} of one call fn(*args), the keys of the JAX
        package's static estimate.  That reads XLA's cost analysis of
        the compiled program, every operation included, without running
        it; here fn runs once under
        `torch.utils.flop_counter.FlopCounterMode`, which counts only the
        operations it has formulas for (matrix products, convolutions,
        attention; elementwise work and hand-written kernels count
        zero), and "bytes" is the bytes of the tensor arguments and
        results, each read or written once, not the traffic of the
        intermediates."""
        from torch.utils.flop_counter import FlopCounterMode

        def nbytes(x):
            if torch.is_tensor(x):
                return x.numel() * x.element_size()
            if isinstance(x, (list, tuple)):
                return sum(nbytes(y) for y in x)
            if isinstance(x, dict):
                return sum(nbytes(y) for y in x.values())
            return 0

        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
        return {"flops": float(fc.get_total_flops()),
                "bytes": float(nbytes(args) + nbytes(out))}

    @staticmethod
    @contextlib.contextmanager
    def device_trace(logdir: str):
        """Record a `torch.profiler` trace of a block (host and, where
        there is a card, CUDA activity) into `logdir`, in the format the
        TensorBoard plugin and Perfetto read."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            yield


def _process_gather(v: float):
    """A host scalar from every rank of the initialized default process
    group (a collective: every rank prints the report), else [v]; the
    report's t_min, t_max, t_avg, f_total and f/s_total reduce over it
    (profile.txx:293-304)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return [v]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, float(v))
    return out


def _sync_devices():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _bump_counters(pairs):
    for name, v in pairs:
        Profile.increment_counter(name, float(v))


def add_flops(n: float):
    """Credit FLOPs from a kernel's static cost model
    (reference: generic-kernel.txx:188)."""
    _bump_counters((("FLOP", n),))


def add_comm(count: int, nbytes: float, collective: bool = True):
    """Credit a communication event (reference: comm.txx:229-230)."""
    if collective:
        _bump_counters((("COLL_COUNT", count), ("COLL_BYTES", nbytes)))
    else:
        _bump_counters((("COMM_COUNT", count), ("COMM_BYTES", nbytes)))
