"""Argument checks shared by the kernel wrappers: a CUDA kernel takes
contiguous float tensors of one type it was built for (float32; the
pair kernels also float64) and int32 counts and indices on one card,
and nothing else."""

from __future__ import annotations

import torch

# Pair budget of one chunk of a plain version: bounds the memory of
# the (..., T, S) pairwise intermediates.
CHUNK_PAIRS = 1 << 22


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a card (the kernel runs), False
    when they lie on the CPU (the plain version runs).  Mixed devices
    and other device types raise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on devices {[t.device for t in tensors]}"
                         ": expected all on the CPU or all on one card")
    return True


def n_sms(device) -> int:
    """The card's SM count (a grid that splits its work reads it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_kernel_args(name: str, dtypes=(torch.float32,),
                      **tensors: torch.Tensor) -> torch.dtype:
    """Float tensors of a launch: contiguous, one type for all, and that
    type among `dtypes`; returns it."""
    types = {t.dtype for t in tensors.values()}
    if len(types) != 1 or not types <= set(dtypes):
        raise NotImplementedError(
            f"{name}: dtypes "
            f"{ {k: t.dtype for k, t in tensors.items()} }; the CUDA "
            f"kernel takes one of {dtypes} for all")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return types.pop()


def check_index_args(name: str, **tensors) -> None:
    """Counts, ranges and indices: contiguous int32 (None: absent)."""
    for key, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise NotImplementedError(
                f"{name}: {key} is {t.dtype}; the CUDA kernel takes int32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
