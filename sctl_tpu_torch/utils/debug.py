"""Diagnosability tools: the functional-setting MEMDEBUG (counterpart of
sctl_tpu/utils/debug.py; reference: SCTL_MEMDEBUG iterators
iterator.txx:42-55, mem_mgr.txx:39-46, stacktrace.h:112-131, SURVEY.md
§5.2).  PyTorch owns the memory; what is checked is values, shapes and
indices:

  check_finite(x, name)   NaN / Inf tripwire, raises FloatingPointError
  guard(fn)               every floating tensor argument and result of
                          fn checked finite
  shape_contract(**spec)  declared shapes and dtype kinds at an entry
                          point, ValueError on a mismatch
  checked_call(fn, ...)   fn run with every index checked against the
                          indexed extent before it is used, NaN
                          production and integer division by zero
                          raising
  enable_nan_debugging()  a NaN trap at the torch call that made it
  install_traceback()     native stack traces on fatal signals

The first three act only when `config.debug` (SCTL_MEMDEBUG) is on.
"""

from __future__ import annotations

import functools
import inspect

import torch
from torch.overrides import TorchFunctionMode

from .. import config


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for y in x for leaf in _leaves(y)]
    if isinstance(x, dict):
        return [leaf for y in x.values() for leaf in _leaves(y)]
    return [x]


def check_finite(x, name: str = "array"):
    """Raise FloatingPointError if x holds a NaN or an Inf (when
    config.debug is on); return x.  Reads one flag back from the card
    (the JAX package prints instead when traced)."""
    if not config.debug:
        return x
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x


def guard(fn):
    """Check all floating tensor inputs and outputs of fn when
    config.debug is on (the per-access MEMDEBUG discipline at function
    granularity)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if config.debug:
            for i, a in enumerate(_leaves((args, kwargs))):
                if torch.is_tensor(a) and a.is_floating_point():
                    check_finite(a, f"{fn.__name__} arg {i}")
        out = fn(*args, **kwargs)
        if config.debug:
            for i, a in enumerate(_leaves(out)):
                if torch.is_tensor(a) and a.is_floating_point():
                    check_finite(a, f"{fn.__name__} out {i}")
        return out
    return wrapped


def _kind_ok(a, kind: str) -> bool:
    dt = a.dtype
    if torch.is_tensor(a):
        if kind == "float":
            return dt.is_floating_point
        return not dt.is_floating_point and not dt.is_complex \
            and dt != torch.bool
    import numpy as np
    return np.issubdtype(dt, np.floating if kind == "float"
                         else np.integer)


def shape_contract(**specs):
    """Declarative shape / dtype contracts on entry points, the
    functional analogue of MEMDEBUG's bounds checks: specs map argument
    names to shape tuples of ints (exact), strings (symbolic dims, equal
    strings match across arguments) or None (any), and a trailing
    "float" / "int" constrains the dtype kind.  Checked only when
    config.debug is on; a violation raises ValueError naming the
    argument.

        @shape_contract(xt=("N", 3), xs=("M", 3), f=("M", None))
        def direct(xt, xs, f): ...
    """
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if config.debug:
                bound = sig.bind_partial(*args, **kwargs)
                dims = {}
                for name, spec in specs.items():
                    a = bound.arguments.get(name)
                    if a is None or not hasattr(a, "shape"):
                        continue
                    shape_spec = [s for s in spec
                                  if s not in ("float", "int")]
                    kind = [s for s in spec if s in ("float", "int")]
                    if len(a.shape) != len(shape_spec):
                        raise ValueError(
                            f"{fn.__name__}: {name} has rank "
                            f"{len(a.shape)}, contract wants "
                            f"{len(shape_spec)} ({spec})")
                    for d, s in zip(a.shape, shape_spec):
                        if s is None:
                            continue
                        if isinstance(s, int):
                            if d != s:
                                raise ValueError(
                                    f"{fn.__name__}: {name} dim {d} "
                                    f"!= {s} (contract {spec})")
                        else:
                            if s in dims and dims[s] != d:
                                raise ValueError(
                                    f"{fn.__name__}: {name} dim "
                                    f"'{s}'={d} inconsistent with "
                                    f"{dims[s]}")
                            dims[s] = d
                    if kind and not _kind_ok(a, kind[0]):
                        raise ValueError(
                            f"{fn.__name__}: {name} dtype {a.dtype} is "
                            f"not {kind[0]}")
            return fn(*args, **kwargs)
        return wrapped
    return deco


def _check_index(idx, size: int, what: str):
    """Raise IndexError unless every integer index in idx lies in
    [-size, size)."""
    if isinstance(idx, int) and not isinstance(idx, bool):
        bad = not -size <= idx < size
    elif (torch.is_tensor(idx) and not idx.is_floating_point()
          and idx.dtype != torch.bool and idx.numel()):
        bad = bool(((idx < -size) | (idx >= size)).any())
    else:
        return
    if bad:
        raise IndexError(f"checked_call: index out of bounds in {what} "
                         f"(extent {size})")


def _check_getitem(t: torch.Tensor, key, what: str):
    """The indices of t[key] on the axes before any Ellipsis."""
    axis = 0
    for k in key if isinstance(key, tuple) else (key,):
        if k is Ellipsis:
            return
        if k is not None and axis < t.ndim:
            _check_index(k, t.shape[axis], what)
        axis += k is not None


class _Checked(TorchFunctionMode):
    """Index bounds before each indexing call; NaN in a floating result
    whose inputs held none; integer division by zero."""

    # calls whose arguments are (tensor, dim, index, ...)
    _INDEXED = {
        torch.index_select, torch.Tensor.index_select, torch.gather,
        torch.Tensor.gather, torch.Tensor.index_add_, torch.Tensor.index_add,
        torch.Tensor.index_copy_, torch.Tensor.index_fill_,
        torch.Tensor.scatter_, torch.Tensor.scatter_add_}
    _DIV = {torch.div, torch.Tensor.div, torch.Tensor.__truediv__,
            torch.Tensor.__floordiv__, torch.floor_divide,
            torch.remainder, torch.Tensor.__mod__, torch.fmod}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            _check_getitem(args[0], args[1], name)
        elif func in self._INDEXED:
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            idx = kwargs.get("index", args[2] if len(args) > 2 else None)
            t = args[0]
            _check_index(idx, t.shape[dim] if t.ndim else 1, name)
        elif func in (torch.take, torch.Tensor.take):
            _check_index(args[1], args[0].numel(), name)
        if func in self._DIV and len(args) > 1:
            a, b = args[0], args[1]
            ints = all(not (torch.is_tensor(x) and (x.is_floating_point()
                                                    or x.is_complex()))
                       and not isinstance(x, float) for x in (a, b))
            if ints and bool(torch.as_tensor(b).eq(0).any()):
                raise ZeroDivisionError(f"checked_call: integer division "
                                        f"by zero in {name}")
        out = func(*args, **kwargs)
        if torch.is_tensor(out) and out.is_floating_point() \
                and bool(torch.isnan(out).any()):
            ins = [a for a in _leaves((args, kwargs))
                   if torch.is_tensor(a) and a.is_floating_point()]
            if not any(bool(torch.isnan(a).any()) for a in ins):
                raise FloatingPointError(f"checked_call: NaN produced by "
                                         f"{name}")
        return out


def checked_call(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) with an explicit bound check of every
    index given to an indexing call (``t[i]``, index_select, gather,
    take, index_add_, scatter_ ...) before the call runs, and raise on
    the first NaN a call produces and on integer division by zero — the
    checks the JAX package gets from checkify (index, NaN and division
    checks).  On the card a bad index would otherwise end in a
    device-side assert that poisons the CUDA context; checked here it
    is an IndexError on the host.  Each check reads a flag back from
    the card: a debugging tool, slow by design.  Hand-written kernels
    (ctypes launches) are not torch calls and are not checked inside."""
    with _Checked():
        return fn(*args, **kwargs)


_nan_mode = None


class _NanTrap(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_tensor(out) and out.is_floating_point() \
                and bool(torch.isnan(out).any()):
            raise FloatingPointError(
                f"NaN produced by {getattr(func, '__name__', func)}")
        return out


def enable_nan_debugging(flag: bool = True):
    """NaN traps: with flag, every torch call from Python raises
    FloatingPointError when its floating result holds a NaN, so the
    error points at the producing call (the JAX package flips
    jax_debug_nans, which XLA checks inside compiled programs), and
    autograd's anomaly mode checks the backward pass.  The check reads
    one flag back from the card after every call; the hand-written
    kernels, launched through ctypes, are caught at the next torch call
    that reads their output."""
    global _nan_mode
    torch.autograd.set_detect_anomaly(flag)
    if flag and _nan_mode is None:
        _nan_mode = _NanTrap()
        _nan_mode.__enter__()
    elif not flag and _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None


def install_traceback():
    """Native stack traces on fatal signals (reference:
    stacktrace.h:112-131), through faulthandler, as in the JAX package.
    A fault inside a CUDA kernel raises no signal: it surfaces as a
    CUDA error at the next call that synchronizes with the card
    (CUDA_LAUNCH_BLOCKING=1 in the environment before the first CUDA
    call makes that the launching call)."""
    import faulthandler
    faulthandler.enable(all_threads=True)
