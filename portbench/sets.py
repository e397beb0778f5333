"""Run sets of runs of one cell, one process after another, and report
each metric's spread: the measurement behind a bound.

    python3 -m portbench.sets --workload <name> --seeds 11 12 13 \
        --repeat 2 [--seconds S] [--trace 0|1] --out runs.jsonl

runs `python3 -m portbench.run` once per seed, `--repeat` times over
the same seeds (each pass is one set), appends each run's result line,
standard error's last lines and wall time to `--out`, and prints each
metric's median and spread (quartile distance over the median,
`statistics.quantiles`) per set.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from portbench import harness
from portbench.stats import spread


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True,
                       cwd=harness.CHECKOUT, timeout=1800)
    rec = dict(workload=workload, seed=seed, trace=trace, rc=p.returncode,
               wall_s=time.perf_counter() - t,
               stderr_tail=p.stderr[-6000:])
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = args.seconds or harness.benchmark()["run_seconds"]
    sets = []
    with open(args.out, "a") as fh:
        for r in range(args.repeat):
            recs = []
            for seed in args.seeds:
                rec = run_once(args.workload, seed, seconds, args.trace)
                rec["set"] = r
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                res = rec.get("result", {})
                print(f"set {r} seed {seed} rc {rec['rc']} wall "
                      f"{rec['wall_s']:.1f} s correct {res.get('correct')} "
                      + " ".join(f"{k}={v['value']!r}" for k, v in
                                 res.get("metrics", {}).items())
                      + " " + " ".join(f"{k}={v['value']!r}" for k, v in
                                       res.get("checks", {}).items()),
                      flush=True)
                recs.append(res)
            sets.append(recs)
    for r, recs in enumerate(sets):
        names = sorted({k for res in recs for k in res.get("metrics", {})})
        for k in names:
            vals = [res["metrics"][k]["value"] for res in recs
                    if k in res.get("metrics", {})]
            if len(vals) >= 2:
                med = sorted(vals)[len(vals) // 2]
                print(f"set {r} {k}: median {med!r} spread "
                      f"{spread(vals)!r} over {len(vals)} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
