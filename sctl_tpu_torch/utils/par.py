"""Shared-memory parallel primitives on tensors (counterpart of
sctl_tpu/utils/par.py; reference: include/sctl/ompUtils.hpp:27-74,
omp_par::merge, merge_sort, reduce, scan).  On the card each is one
torch call, whose kernels are the parallel loop; thin wrappers so that
algorithm code reads like the reference."""

from __future__ import annotations

import torch


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted 1-D tensors (omp_par::merge, ompUtils.txx:17)."""
    return torch.sort(torch.cat([a, b])).values


def merge_sort(x: torch.Tensor, keys: torch.Tensor = None):
    """Sort x (omp_par::merge_sort); with keys, a stable sort by keys
    -> (sorted keys, x in that order)."""
    if keys is None:
        return torch.sort(x).values
    order = torch.argsort(keys, stable=True)
    return keys[order], x[order]


def reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduction of all of x (omp_par::reduce): sum, max, min or prod."""
    return {"sum": torch.sum, "max": torch.max, "min": torch.min,
            "prod": torch.prod}[op](x)


def scan(x: torch.Tensor, op: str = "sum",
         exclusive: bool = True) -> torch.Tensor:
    """Prefix sum, max or min of a 1-D tensor (omp_par::scan), exclusive
    by default as the reference's tree construction uses it; the
    exclusive max / min start from the identity (-inf / inf, or the
    integer type's limits)."""
    if op == "sum":
        inc = torch.cumsum(x, 0)
        return inc - x if exclusive else inc
    inc = (torch.cummax if op == "max" else torch.cummin)(x, 0).values
    if not exclusive:
        return inc
    if x.is_floating_point():
        ident = float("-inf") if op == "max" else float("inf")
    else:
        info = torch.iinfo(x.dtype)
        ident = info.min if op == "max" else info.max
    return torch.cat([x.new_full((1,), ident), inc[:-1]])
