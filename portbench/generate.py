"""The one generator of every traffic mix: it reads a mix's parameters
(the `traffic/<mix>.json` file) and makes the inputs from the run's
seed.  Each stream of inputs (the points, the i-th density, the check's
sample) has its own generator seeded from (seed, stream, index), so the
same seed gives the same inputs, and the reference can make again what
the program was given.

A mix names the law of each input, and each law is a file of its own,
`laws/<law>.py`, whose `draw` makes the values from the stream's
generator: a new law is a new file.

  points     `draw(spec, g, device)` -> (N, 3) float64 points, on the
             host (see `points`).  With
             `set`, the set that seed draws, for every run's seed: a
             mix whose work depends on the draw (the largest box count
             of a point set) gives every seed the same work, on its own
             densities.
  densities  `draw(spec, g, shape, device, dtype)`.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np
import torch

LAWS = Path(__file__).resolve().parent / "laws"

STREAMS = {"points": 1, "density": 2, "warm": 3, "sample": 4}


def subseed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream's index-th draw."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream],
                                 int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(subseed(seed, stream, index))
    return g


@functools.lru_cache(maxsize=None)
def law(name: str):
    """The `draw` function of laws/<name>.py."""
    path = LAWS / f"{name}.py"
    if not path.exists():
        raise ValueError(f"unknown law {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_law_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.draw


def points(spec: dict, seed: int, device) -> torch.Tensor:
    """(N, 3) float64 points on the device, drawn on the host, where
    the program builds its tree from them: a set, and the work it
    gives, can be read without a card."""
    g = generator(spec.get("set", seed), "points", 0, "cpu")
    return law(spec["law"])(spec, g, "cpu").to(device)


def densities(spec: dict, seed: int, stream: str, index: int, n: int,
              k0: int, device, dtype) -> torch.Tensor:
    """(n, k0) density values of draw `index` of `stream`."""
    return law(spec["law"])(spec, generator(seed, stream, index, device),
                            (n, k0), device, dtype)


def sample(seed: int, n: int, k: int) -> np.ndarray:
    """k distinct indices of range(n) for the check, sorted."""
    rng = np.random.default_rng(subseed(seed, "sample"))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
