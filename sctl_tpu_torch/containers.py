"""Containers: Vector / Matrix / Permutation / Tensor over torch tensors
(counterpart of sctl_tpu/containers.py; reference:
include/sctl/vector.hpp, matrix.hpp, permutation.hpp, tensor.hpp).

Thin functional wrappers: methods return new objects, and the tensor
inside (`.data`) keeps its device and dtype.  A wrapper built from a
tensor stays on that tensor's device; one built from other data goes
to `device` (default the card, `config.resolve_device`).

  Vector       dim, elementwise ops, push_back, binary write / read with
               a cross-dtype conversion (vector.hpp:94-117)
  Matrix       GEMM (matrix.hpp:205-225), row_perm / col_perm (342-349),
               transpose (356-364), svd (367-375), pinv (385) through
               torch.linalg, IO (81-104)
  Permutation  indices and a diagonal scaling, compose and apply
               (permutation.hpp:21-)
  Tensor       a shaped tensor with order / size / dim (tensor.hpp:30-45)

The files: `write_array` / `read_array` write and read the JAX
package's self-describing layout (magic "SCTL_TPU", dtype code, rank,
dims, raw little-endian data), byte for byte; `write_array_sctl` /
`read_array_sctl` the reference's (dim0, dim1) uint64 header and raw
data.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from .config import resolve_device

_MAGIC = b"SCTL_TPU"
_DTYPE_CODES = {
    "float32": 0, "float64": 1, "int32": 2, "int64": 3,
    "uint32": 4, "uint64": 5, "complex64": 6, "complex128": 7,
    "bfloat16": 8, "int8": 9, "uint8": 10, "bool": 11, "float16": 12,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64,
          "uint32": torch.uint32, "uint64": torch.uint64,
          "complex64": torch.complex64, "complex128": torch.complex128,
          "bfloat16": torch.bfloat16, "int8": torch.int8,
          "uint8": torch.uint8, "bool": torch.bool,
          "float16": torch.float16}
_NAME = {v: k for k, v in _TORCH.items()}


def _dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(d, torch.dtype):
        return d
    return _TORCH[str(d) if str(d) == "bfloat16" else np.dtype(d).name]


def _as_tensor(data, device=None) -> torch.Tensor:
    """`data` as a tensor: a tensor keeps its device unless `device` is
    given; other data goes to `device` (default the card)."""
    if torch.is_tensor(data):
        return data if device is None else data.to(resolve_device(device))
    return torch.as_tensor(data, device=resolve_device(device))


def _host(arr, dtype=None) -> torch.Tensor:
    """A contiguous CPU tensor of `arr` (tensor or array-like), cast to
    `dtype` if given."""
    t = (arr.detach().cpu() if torch.is_tensor(arr)
         else torch.as_tensor(np.asarray(arr)))
    if dtype is not None:
        t = t.to(_dtype(dtype))
    return t.contiguous()


def _raw(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_raw(buf: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    n = int(np.prod(shape)) if len(shape) else 1
    if n == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(buf), dtype=dtype,
                            count=n).reshape(tuple(shape))


def write_array(path: str, arr, dtype=None) -> None:
    """Binary writer with an optional cross-dtype conversion, the JAX
    package's layout (sctl_tpu/containers.py:43-54): magic, dtype code
    and rank (uint32), dims (uint64), raw data."""
    t = _host(arr, dtype)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<II", _DTYPE_CODES[_NAME[t.dtype]], t.ndim))
        f.write(struct.pack(f"<{t.ndim}Q", *t.shape))
        f.write(_raw(t))


def read_array(path: str, dtype=None, device=None) -> torch.Tensor:
    """Read a `write_array` file (either package's) into a tensor on
    `device` (default the card), converted to `dtype` if given."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        code, ndim = struct.unpack("<II", f.read(8))
        shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
        a = _from_raw(f.read(), _TORCH[_CODE_DTYPES[code]], shape)
    if dtype is not None:
        a = a.to(_dtype(dtype))
    return a.to(resolve_device(device))


def read_array_sctl(path: str, dtype, out_dtype=None,
                    device=None) -> torch.Tensor:
    """Read a file of the reference's Vector/Matrix::Write
    (vector.txx:107-118, matrix.txx:114-126): a little-endian (dim0,
    dim1) uint64 header and raw data of the element type `dtype`, which
    the file does not store.  Shape (dim0,) where dim1 == 1 (the Vector
    layout), else (dim0, dim1)."""
    with open(path, "rb") as f:
        d0, d1 = struct.unpack("<QQ", f.read(16))
        a = _from_raw(f.read(), _dtype(dtype), (d0, d1))
    a = a[:, 0] if d1 == 1 else a
    if out_dtype is not None:
        a = a.to(_dtype(out_dtype))
    return a.to(resolve_device(device))


def write_array_sctl(path: str, arr, dtype=None) -> None:
    """Write the reference's Vector (1-D, dim1 = 1) or Matrix (2-D)
    layout, so the files interchange with the reference's cached
    tables."""
    t = _host(arr, dtype)
    if t.ndim == 1:
        d0, d1 = t.shape[0], 1
    elif t.ndim == 2:
        d0, d1 = t.shape
    else:
        raise ValueError("reference layout is 1-D/2-D only")
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", d0, d1))
        f.write(_raw(t))


class Vector:
    """1-D tensor wrapper (reference: vector.hpp)."""

    def __init__(self, data=(), device=None):
        self.data = torch.atleast_1d(_as_tensor(data, device))

    def dim(self) -> int:
        return self.data.shape[0]

    def __len__(self):
        return self.dim()

    def __getitem__(self, i):
        return self.data[i]

    def set(self, i, v) -> "Vector":
        d = self.data.clone()
        d[i] = v
        return Vector(d)

    def push_back(self, v) -> "Vector":
        v = torch.atleast_1d(torch.as_tensor(v, dtype=self.data.dtype,
                                             device=self.data.device))
        return Vector(torch.cat([self.data, v]))

    # elementwise arithmetic
    def _bin(self, other, op):
        o = other.data if isinstance(other, Vector) else other
        return Vector(op(self.data, o))

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __radd__(self, o):
        return self._bin(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._bin(o, torch.sub)

    def __rsub__(self, o):
        return self._bin(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    def __rmul__(self, o):
        return self._bin(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._bin(o, torch.div)

    def __neg__(self):
        return Vector(-self.data)

    def norm2(self):
        return torch.linalg.vector_norm(self.data)

    def write(self, path: str, dtype=None) -> None:
        write_array(path, self.data, dtype)

    @staticmethod
    def read(path: str, dtype=None, device=None) -> "Vector":
        return Vector(read_array(path, dtype, device))

    def __repr__(self):
        return f"Vector({self.data})"


class Matrix:
    """Row-major 2-D matrix wrapper (reference: matrix.hpp)."""

    def __init__(self, data, device=None):
        d = _as_tensor(data, device)
        if d.ndim == 1:
            d = d[None, :]
        if d.ndim != 2:
            raise ValueError(f"Matrix needs 2-D data, got {d.ndim}-D")
        self.data = d

    @staticmethod
    def zeros(n0: int, n1: int, dtype=torch.float64,
              device=None) -> "Matrix":
        return Matrix(torch.zeros((n0, n1), dtype=_dtype(dtype),
                                  device=resolve_device(device)))

    def dim(self, i: int) -> int:
        return self.data.shape[i]

    def __getitem__(self, idx):
        return self.data[idx]

    # -- ops (reference: matrix.hpp:205-225) -----------------------------
    def __matmul__(self, other: "Matrix") -> "Matrix":
        return Matrix(self.data @ other.data)

    def __add__(self, o):
        o = o.data if isinstance(o, Matrix) else o
        return Matrix(self.data + o)

    def __sub__(self, o):
        o = o.data if isinstance(o, Matrix) else o
        return Matrix(self.data - o)

    def __mul__(self, s):
        return Matrix(self.data * s)

    def __rmul__(self, s):
        return Matrix(s * self.data)

    def __neg__(self):
        return Matrix(-self.data)

    def transpose(self) -> "Matrix":
        return Matrix(self.data.T)

    def svd(self):
        """Thin SVD, (U, S, Vt) — reference: matrix.hpp:367-375."""
        u, s, vt = torch.linalg.svd(self.data, full_matrices=False)
        return Matrix(u), Vector(s), Matrix(vt)

    def pinv(self, eps: Optional[float] = None) -> "Matrix":
        """Moore-Penrose pseudo-inverse through the SVD (matrix.hpp:385):
        singular values at most eps max(s) are dropped, eps by default
        the dtype's machine epsilon times max(shape)."""
        u, s, vt = torch.linalg.svd(self.data, full_matrices=False)
        if eps is None:
            eps = torch.finfo(self.data.dtype).eps * max(self.data.shape)
        keep = s > eps * s.max()
        sinv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
        return Matrix((vt.T * sinv) @ u.T)

    def row_perm(self, p: "Permutation") -> "Matrix":
        """M -> P M: permute and scale rows (matrix.hpp:342-345)."""
        return Matrix(self.data[p.perm, :] * p.scal[:, None])

    def col_perm(self, p: "Permutation") -> "Matrix":
        """M -> M P: permute and scale columns (matrix.hpp:346-349)."""
        return Matrix(self.data[:, p.perm] * p.scal[None, :])

    def write(self, path: str, dtype=None) -> None:
        write_array(path, self.data, dtype)

    @staticmethod
    def read(path: str, dtype=None, device=None) -> "Matrix":
        return Matrix(read_array(path, dtype, device))

    def __repr__(self):
        return f"Matrix({self.data})"


class Permutation:
    """Permutation operator P = scal * permutation matrix
    (permutation.hpp:21); applied to a Matrix it permutes rows or
    columns and scales them by the diagonal."""

    def __init__(self, perm, scal=None, device=None):
        self.perm = _as_tensor(perm, device).to(torch.int64)
        self.scal = (_as_tensor(scal, device) if scal is not None
                     else torch.ones(self.perm.shape, dtype=torch.float64,
                                     device=self.perm.device))

    @staticmethod
    def rand_perm(n: int, generator: Optional[torch.Generator] = None,
                  device=None) -> "Permutation":
        """A random permutation and uniform scaling in [0, 1), drawn from
        `generator` (on `device`, default the card)."""
        dev = resolve_device(device)
        return Permutation(
            torch.randperm(n, generator=generator, device=dev),
            torch.rand(n, generator=generator, dtype=torch.float64,
                       device=dev))

    def dim(self) -> int:
        return self.perm.shape[0]

    def get_matrix(self) -> Matrix:
        n = self.dim()
        m = torch.zeros((n, n), dtype=self.scal.dtype,
                        device=self.scal.device)
        m[torch.arange(n, device=m.device), self.perm] = self.scal
        return Matrix(m)

    def transpose(self) -> "Permutation":
        inv = torch.argsort(self.perm)
        return Permutation(inv, self.scal[inv])

    def __matmul__(self, other):
        if isinstance(other, Permutation):
            # (P1 P2)(e_i): the row view, as get_matrix composes
            return Permutation(self.perm[other.perm],
                               self.scal[other.perm] * other.scal)
        if isinstance(other, Matrix):
            return other.row_perm(self)
        raise TypeError(type(other))


class Tensor:
    """Shaped tensor (reference: tensor.hpp:30-45): order, size, dim and
    the cyclic axis rotations."""

    def __init__(self, data, shape=None, device=None):
        self.data = _as_tensor(data, device)
        if shape is not None:
            self.data = self.data.reshape(shape)

    @property
    def order(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return self.data.numel()

    def dim(self, i: int) -> int:
        return self.data.shape[i]

    def rotate_left(self) -> "Tensor":
        """Cyclic axis rotation (tensor.hpp:12-13)."""
        return Tensor(torch.movedim(self.data, 0, -1))

    def rotate_right(self) -> "Tensor":
        return Tensor(torch.movedim(self.data, -1, 0))

    def __add__(self, o):
        return Tensor(self.data + (o.data if isinstance(o, Tensor) else o))

    def __sub__(self, o):
        return Tensor(self.data - (o.data if isinstance(o, Tensor) else o))

    def __mul__(self, s):
        return Tensor(self.data * s)

    def __matmul__(self, o):
        return Tensor(torch.tensordot(
            self.data, o.data if isinstance(o, Tensor) else o, dims=1))
