"""Runtime settings of the PyTorch port.

Counterpart of `sctl_tpu/config.py:42-87`, cut to what the port reads:
the default device and the float32 precision rule.
There are no kernel toggles: a CUDA tensor goes through the hand-written
kernel of its stage, a CPU tensor through that kernel's plain PyTorch
version, and nothing selects between them but the tensor's device.
"""

from __future__ import annotations

import torch

# Entry points run on the card unless the caller passes device="cpu".
DEFAULT_DEVICE = "cuda"


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
