"""One run of one cell: set-up, the measured window, the check and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: `BENCHMARK.json` names the cell's
configuration and mix; the configuration's file (its `file` entry)
names its driver by `kind` (`drivers/<kind>.py`), the mix is
`traffic/<mix>.json`, and each per-layer metric is read by
`metrics/<metric>.py`, whose `read(data)` returns a number or None
(nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "sctl_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_files(bench: dict, workload: str):
    """(cell, configuration, traffic) dicts of a workload's name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(CHECKOUT / cfg_entry["file"])
    trf = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, trf


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def stage_ms(marks) -> list:
    """The program's CUDA-event marks of one timed call -> one dict of
    stage milliseconds per apply, each stage from the mark before."""
    out = []
    for m in marks:
        d, prev = {}, m[0][1]
        for name, ev in m[1:]:
            d[name] = d.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        out.append(d)
    return out


def build_kernels() -> dict:
    """Load the program's kernel libraries, which it builds on first
    use where a source is newer than the library (the first run of a
    checkout): {"build_s": seconds, "built": [the libraries compiled]}.
    Called first in a run's set-up, so that the build is timed apart;
    `setup_s` holds it, as it holds every part of the set-up."""
    from sctl_tpu_torch import native
    from sctl_tpu_torch.ops import _build
    libs = (("kernels", _build.library, _build.BUILD_DIR / _build.LIB_NAME),
            ("native", native.get_lib, native._SO))
    t = time.perf_counter()
    built = []
    for name, load, so in libs:
        before = so.stat().st_mtime if so.exists() else None
        load()
        if so.exists() and so.stat().st_mtime != before:
            built.append(name)
    return {"build_s": time.perf_counter() - t, "built": built}


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, control: bool = False,
             overrides: dict = None):
    """One run -> (result, info): the result line's fields (see
    `run.py`) and what standard error reports beside them.

    control: the check's control, switched on once the program is set
    up: its float32 matrix products on the tensor cores' TF32 path
    (`allow_tf32`).  overrides: {"config": {...}, "traffic": {...}}
    entries that replace the files' (tests at small sizes)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    bench = benchmark()
    cell, cfg, trf = cell_files(bench, workload)
    for key, d in (overrides or {}).items():
        {"config": cfg, "traffic": trf}[key].update(d)
    import sctl_tpu_torch  # noqa: F401  (sets the program's precision)
    build = None
    if device.type == "cuda":
        build = build_kernels()
        torch.cuda.reset_peak_memory_stats(device)
    c = driver(cfg["kind"]).Cell(cfg, trf, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    from .trace import Trace
    tracer = Trace(trace)
    times, marks = [], []
    with tracer.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            inp = c.prepare(i)
            sync(device)
            m = [] if trace else None
            t = time.perf_counter()
            out = c.call(inp, m)
            sync(device)
            t1 = time.perf_counter()
            times.append(t1 - t)
            if m is not None:
                marks.append(m)
            c.keep(i, inp, out)
            del out
            i += 1
            if t1 - t0 >= seconds:
                break
    window_s = t1 - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    stages = [stage_ms(m) for m in marks]
    data = dict(c.layer_data(), calls=stages, times=times,
                window_s=window_s)
    summary = tracer.summary()
    data["device"] = summary
    failed = c.failed()
    e2e = dict(c.end_to_end(times, window_s), setup_s=setup_s)
    c.release()
    checks = c.checks() + [("failed", float(failed), 0.0)]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = metric_reader(m["name"])(data)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, workload)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": bool(correct), "attempted": len(times),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        res["breakdown"] = summary["breakdown"]
    if build is not None:
        res["build_s"] = build["build_s"]
    res["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    info = dict(end_to_end=e2e, build=build, calls=len(times),
                window_s=window_s,
                call_s_median=sorted(times)[len(times) // 2],
                call_s_max=max(times), first_call_s=times[0],
                work=data.get("work"))
    applies_ = [a for call in stages for a in call]
    if applies_:
        info["stage_ms_mean"] = {k: sum(a.get(k, 0.0) for a in applies_)
                                 / len(applies_) for k in applies_[0]}
    if summary is not None:
        info.update(busy_s=summary["busy_s"],
                    traced_window_s=summary["window_s"])
    return res, info
