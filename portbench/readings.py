"""The readings that a cell's check limits are set from, in one
process on the card: the program's numbers on many seeds, then the
control's on a few.

    python3 -m portbench.readings --workload <name> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds S] --out readings.jsonl

Each seed is one run of the cell (set-up, a window of --seconds,
default the benchmark's, and the check).  The control is the program with its own float32 matrix
products on the TF32 path (`torch.backends.cuda.matmul.allow_tf32`),
switched on after the program's seeds, for the rest of the process:
the nearest precision below the configurations' float32 with TF32 off.
A control run that raises counts as failed and gives no number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = args.seconds or harness.benchmark()["run_seconds"]
    with open(args.out, "a") as fh:
        for control, seeds in ((False, args.seeds),
                               (True, args.control_seeds)):
            for seed in seeds:
                t = time.perf_counter()
                rec = dict(workload=args.workload, seed=seed,
                           control=control)
                try:
                    res, info = harness.run_cell(
                        args.workload, seed, seconds, False, "cuda",
                        control=control)
                    rec.update(correct=res["correct"], checks=res["checks"],
                               attempted=res["attempted"],
                               failed=res["failed"], info=info)
                except Exception:                  # the control may crash
                    rec["error"] = traceback.format_exc()[-3000:]
                rec["wall_s"] = time.perf_counter() - t
                fh.write(json.dumps(rec, default=str) + "\n")
                fh.flush()
                print(f"{'control' if control else 'program'} seed {seed}: "
                      f"wall {rec['wall_s']:.1f} s, correct "
                      f"{rec.get('correct')}, attempted "
                      f"{rec.get('attempted')}, failed {rec.get('failed')}, "
                      + ", ".join(f"{k} {v['value']!r}" for k, v in
                                  rec.get("checks", {}).items())
                      + (" ERROR " + rec["error"].splitlines()[-1]
                         if "error" in rec else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
