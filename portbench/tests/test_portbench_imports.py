"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program.  Top-level module names are
compared whole: `sctl_tpu_torch` is not `sctl_tpu`."""

import json
import subprocess
import sys

from portbench import harness

_LOAD_ALL = """
import json, sys
from portbench import harness, run, sets, readings, generate, trace, stats
from portbench.drivers import kifmm
bench = harness.benchmark()
for w in bench["workloads"]:
    harness.cell_files(bench, w["name"])
    trf = harness.cell_files(bench, w["name"])[2]
    for key in ("points", "densities"):
        generate.law(trf[key]["law"])
for m in bench["per_layer"]:
    harness.metric_reader(m["name"])
import sctl_tpu_torch.fmm, sctl_tpu_torch.ops.kernels
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_LOAD_REFERENCE = """
import json, sys
import portbench.reference.kernels
import portbench.roofline.pairs, portbench.roofline.peaks
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level(_LOAD_ALL)
    assert "sctl_tpu_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "sctl_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(_LOAD_REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "sctl_tpu",
                       "sctl_tpu_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sctl_tpu_torch_x", sys)
    assert "sctl_tpu" not in harness.forbidden_modules() or \
        "sctl_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
