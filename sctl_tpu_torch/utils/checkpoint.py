"""Checkpoint and resume of tensor state (counterpart of
sctl_tpu/utils/checkpoint.py; reference: Vector::Write/Read
vector.hpp:94-117, Matrix::Write/Read matrix.hpp:81-104, SURVEY.md §5.4).

`save` writes nested dicts, lists and tuples of tensors (and Python
numbers) with `torch.save` into one file (".pt" appended where the path
has no suffix); `restore` reads them back with `torch.load` in
`weights_only` mode, which rebuilds the same structure and refuses
arbitrary pickled objects.  The tensors come back on the devices they
were saved from, or with `like=` on the devices of `like`'s tensors.
The JAX package writes an orbax directory or an npz; the files do not
interchange (containers.write_array does, for single arrays).
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _pt(path: str) -> str:
    return path if os.path.splitext(path)[1] else path + ".pt"


def save(path: str, tree: Any) -> None:
    """Save a nested structure of tensors to `path`."""
    torch.save(tree, _pt(path))


def _like(tree, like):
    """`tree`'s tensors moved to the devices of `like`'s, structure
    checked."""
    if torch.is_tensor(like):
        return tree.to(like.device)
    if isinstance(like, dict):
        if set(tree) != set(like):
            raise ValueError(f"checkpoint keys {sorted(tree)} do not match "
                             f"{sorted(like)}")
        return {k: _like(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError(f"checkpoint length {len(tree)} does not "
                             f"match {len(like)}")
        return type(like)(_like(t, l) for t, l in zip(tree, like))
    return tree


def restore(path: str, like: Any = None) -> Any:
    """Restore a structure saved by `save`; with `like`, its tensors go
    to the devices of `like`'s tensors in the same places."""
    tree = torch.load(_pt(path), weights_only=True)
    return tree if like is None else _like(tree, like)


def save_krylov_precond(path: str, kp) -> None:
    """Persist a `linalg.KrylovPrecond`'s recycled subspaces, its (Qt,
    U) pairs newest first (the reference's reuse across solver runs,
    lin-solve.hpp:21-64)."""
    save(path, {"n": kp._n, "pairs": [tuple(p) for p in kp._pairs]})


def restore_krylov_precond(path: str, device=None):
    """A `KrylovPrecond` from `save_krylov_precond`'s file, its tensors on
    the devices they were saved from, or on `device`."""
    from ..linalg.gmres import KrylovPrecond
    z = restore(path)
    kp = KrylovPrecond()
    kp._n = int(z["n"])
    kp._pairs = [tuple(t if device is None else t.to(device) for t in p)
                 for p in z["pairs"]]
    return kp
