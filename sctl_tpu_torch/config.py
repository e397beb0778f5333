"""Runtime settings of the PyTorch port.

Counterpart of `sctl_tpu/config.py:42-87`, cut to what the port reads:
the default device, the float32 precision rule, the data directory and
the three diagnostics settings, `debug` (SCTL_MEMDEBUG, the guards of
`utils.debug`), `profile_level` (SCTL_PROFILE, the depth of the
`profile` blocks that record) and `verbose` (SCTL_VERBOSE).  They are
module attributes, read at each call: `config.profile_level = 1` turns
the profiler's level-0 and level-1 blocks on.  There are no kernel
toggles: a CUDA tensor goes through the hand-written
kernel of its stage, a CPU tensor through that kernel's plain PyTorch
version, and nothing selects between them but the tensor's device.
"""

from __future__ import annotations

import os

import torch

# Entry points run on the card unless the caller passes device="cpu".
DEFAULT_DEVICE = "cuda"


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "off", "")


# Shape, dtype and NaN guards of utils.debug (sctl_tpu/config.py:44-46).
debug: bool = _env_bool("SCTL_MEMDEBUG", False)
# Profile.tic / scoped blocks above this level record nothing; -1 (the
# default) turns every block off (sctl_tpu/config.py:47-50).
profile_level: int = int(os.environ.get("SCTL_PROFILE") or -1)
# Print each profile block as it opens.
verbose: bool = _env_bool("SCTL_VERBOSE", False)


def data_path() -> str:
    """The directory of precomputed tables the port reads (never
    writes): SCTL_DATA_PATH, default ./data/ (sctl_tpu/config.py:56-57).
    It holds the committed hiprec operator tables
    (`fmm.kifmm.unit_tables`)."""
    return os.environ.get("SCTL_DATA_PATH", "./data/")


def set_precision() -> None:
    """float32 means float32: no TF32 in matrix products or
    convolutions (the port's counterpart of `_set_matmul_precision`,
    sctl_tpu/config.py:130-149)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `device` if given, else the
    card.  No silent move to the CPU when the card is missing."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def limit_cpu_threads(n: int = 2) -> None:
    """Cap the process's CPU thread pools at n: torch's intra-op threads
    and, through threadpoolctl, the BLAS and OpenMP pools (numpy's BLAS
    runs the operator tables' SVDs).  Each starts one thread a core; a
    process that shares the host's cores with others (a test run in
    several worker processes) oversubscribes them.  CUDA work is not
    affected."""
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(min(n, torch.get_num_threads()))
    threadpool_limits(n)
