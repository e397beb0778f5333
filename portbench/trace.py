"""The traced run's device trace: torch.profiler's CUDA activity over
the measured window (kernels, copies and sets on the card, and the
CUDA runtime calls that launched them; no host operator events, whose
recording would slow the host-bound stages twofold), reduced to the
device's busy time (the union of the intervals in which a kernel, copy
or set ran), the window's length on the host clock, and the breakdown:
the device operations that took most time and the longest idle gaps,
each named by the innermost host event (a CUDA runtime call) open at
its midpoint, or "no host operation" while the host ran Python."""

from __future__ import annotations

import contextlib

import numpy as np

TOP = 10
NAME_CHARS = 120


def _ns(e, what: str) -> int:
    """An event's start or duration in nanoseconds (older profilers
    give microseconds)."""
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")()) * 1000


def union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(intervals, w0, w1):
    """(busy time, gaps) of device intervals clipped to [w0, w1): the
    union's length and the [start, end) stretches of the window it
    leaves idle."""
    merged = union([(max(s, w0), min(e, w1)) for s, e in intervals
                    if e > w0 and s < w1])
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return busy, gaps


class Trace:
    """`window()` profiles the block's activity on the card when
    `enabled`; `summary()` then reduces it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        with self._prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self._window_s = time.perf_counter() - t0

    def summary(self):
        """dict(busy_s, window_s, breakdown), or None when the trace
        holds no device time."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType
        dev, cpu = [], []
        by_name = {}
        for e in self._prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            name = e.name()
            s = _ns(e, "start")
            d = _ns(e, "duration")
            if e.device_type() == DeviceType.CUDA:
                dev.append((s, s + d))
                by_name[name] = by_name.get(name, 0) + d
            else:
                cpu.append((s, d, name))
        if not dev:
            return None
        w0 = min([s for s, _ in dev] + [c[0] for c in cpu])
        w1 = max([e for _, e in dev] + [c[0] + c[1] for c in cpu])
        busy, gaps = busy_and_gaps(dev, w0, w1)
        if busy <= 0:
            return None
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        starts = np.array([c[0] for c in cpu], np.int64)
        durs = np.array([c[1] for c in cpu], np.int64)
        named = []
        for g0, g1 in top_gaps:
            mid = (g0 + g1) // 2
            hit = np.nonzero((starts <= mid) & (starts + durs >= mid))[0]
            name = ("no host operation" if not len(hit)
                    else cpu[hit[np.argmin(durs[hit])]][2])
            named.append([name[:NAME_CHARS], (g1 - g0) / 1e9])
        return dict(busy_s=busy / 1e9, window_s=self._window_s,
                    breakdown={"device_ops": [[n[:NAME_CHARS], t / 1e9]
                                              for n, t in top_ops],
                               "idle_gaps": named})
