"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics),
`device`, with --trace 1 `breakdown`, then `build_s` (the seconds the
set-up spent loading the program's kernel libraries, which it builds
in the first run of a checkout; `setup_s` holds them too), and last
`checks`: each number the check compared, with its limit.  The same
numbers are the last lines of standard error.

Exits non-zero and prints no result without a CUDA card, with fewer
cards than the cell asks for, or when the process has loaded JAX or
the JAX package.  Kernel builds and caches stay inside the checkout:
the program's kernel library in `sctl_tpu_torch/_build/`, Triton's and
torch's extension caches (should anything use them) under
`.portbench_cache/`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    cache = CHECKOUT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _card() -> str:
    """nvidia-smi's name and power limit of the card."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    import torch
    from portbench import harness
    cell, _, _ = harness.cell_files(harness.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    res, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    info["card"] = _card()
    print("info " + json.dumps(info, default=str), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
