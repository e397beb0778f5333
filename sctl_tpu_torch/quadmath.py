"""Double-double ("QuadReal") arithmetic on the host (counterpart of
sctl_tpu/quadmath.py, the whole module).

A DD value is an unevaluated sum hi + lo of two float64 arrays with |lo|
at most half an ulp of hi, about 106 mantissa bits, built from the
error-free transforms two_sum and two_prod (Dekker, Knuth).  Pure numpy,
the same operations in the same order as the JAX package's module, so
both give the same bits.  Nothing here runs on the card.

Used for: the SDC tables (`linalg.ode`), `interpolation_matrix(dd=True)`
(`linalg.lagrange`), the double-double DFT `linalg.fft.fft_dd`, and
`ld_gemm`, the extended-precision products of the hiprec KIFMM operator
tables (`fmm.kifmm.unit_tables(..., hiprec=True)`).

Representation: ``DD(hi, lo)``, elementwise over arrays of any shape.
"""

from __future__ import annotations

from typing import Union

import numpy as np

_SPLITTER = 134217729.0  # 2**27 + 1, Dekker split constant for float64


def _np(x):
    return np.asarray(x, dtype=np.float64)


class DD:
    """Double-double number/array: value = hi + lo (elementwise)."""

    __slots__ = ("hi", "lo")
    __array_priority__ = 100  # beat numpy broadcasting in mixed ops

    def __init__(self, hi, lo=None):
        if isinstance(hi, DD):
            self.hi, self.lo = hi.hi, hi.lo
            return
        hi = _np(hi)
        self.hi = hi
        self.lo = _np(lo) if lo is not None else np.zeros_like(hi)

    # -- construction helpers ------------------------------------------
    @staticmethod
    def zeros(shape=()):
        z = np.zeros(shape)
        return DD(z, z.copy())

    @property
    def shape(self):
        return self.hi.shape

    def __len__(self):
        return len(self.hi)

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])

    def __setitem__(self, idx, val):
        val = to_dd(val)
        self.hi[idx] = val.hi
        self.lo[idx] = val.lo

    def to_float64(self):
        return self.hi + self.lo

    def __repr__(self):
        return f"DD({self.hi!r}, {self.lo!r})"

    # -- arithmetic -----------------------------------------------------
    def __add__(self, other):
        return dd_add(self, to_dd(other))

    def __radd__(self, other):
        return dd_add(to_dd(other), self)

    def __sub__(self, other):
        return dd_add(self, dd_neg(to_dd(other)))

    def __rsub__(self, other):
        return dd_add(to_dd(other), dd_neg(self))

    def __neg__(self):
        return dd_neg(self)

    def __mul__(self, other):
        return dd_mul(self, to_dd(other))

    def __rmul__(self, other):
        return dd_mul(to_dd(other), self)

    def __truediv__(self, other):
        return dd_div(self, to_dd(other))

    def __rtruediv__(self, other):
        return dd_div(to_dd(other), self)

    def __pow__(self, n):
        if isinstance(n, int):
            return dd_powi(self, n)
        raise TypeError("DD ** only supports integer exponents")

    # -- comparisons (on the exact value) -------------------------------
    def _cmp_key(self, other):
        d = self - to_dd(other)
        return np.where(d.hi != 0, d.hi, d.lo)

    def __lt__(self, other):
        return self._cmp_key(other) < 0

    def __le__(self, other):
        return self._cmp_key(other) <= 0

    def __gt__(self, other):
        return self._cmp_key(other) > 0

    def __ge__(self, other):
        return self._cmp_key(other) >= 0

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp_key(other) == 0

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp_key(other) != 0

    def __hash__(self):  # scalar only
        return hash((float(self.hi), float(self.lo)))


DDLike = Union[DD, float, int, np.ndarray]


def to_dd(x: DDLike) -> DD:
    if isinstance(x, DD):
        return x
    return DD(x)


# -- error-free transforms ----------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    t = _SPLITTER * a
    ahi = t - (t - a)
    alo = a - ahi
    return ahi, alo


def _two_prod(a, b):
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# -- core ops -------------------------------------------------------------

def dd_neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def dd_add(a: DD, b: DD) -> DD:
    s1, s2 = _two_sum(a.hi, b.hi)
    t1, t2 = _two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = _quick_two_sum(s1, s2)
    return DD(s1, s2)


def dd_mul(a: DD, b: DD) -> DD:
    p1, p2 = _two_prod(a.hi, b.hi)
    p2 = p2 + (a.hi * b.lo + a.lo * b.hi)
    p1, p2 = _quick_two_sum(p1, p2)
    return DD(p1, p2)


def dd_div(a: DD, b: DD) -> DD:
    q1 = a.hi / b.hi
    r = dd_add(a, dd_neg(dd_mul(DD(q1), b)))
    q2 = r.hi / b.hi
    r = dd_add(r, dd_neg(dd_mul(DD(q2), b)))
    q3 = r.hi / b.hi
    s1, s2 = _quick_two_sum(q1, q2)
    return dd_add(DD(s1, s2), DD(q3))


def dd_sqrt(a: DD) -> DD:
    """Newton iteration x -> x*(3 - a*x^2)/2 on 1/sqrt, then multiply."""
    x = 1.0 / np.sqrt(a.hi)
    ax = DD(a.hi * x)
    err = dd_add(a, dd_neg(dd_mul(ax, ax)))
    return dd_add(ax, DD(err.hi * (x * 0.5)))


def dd_abs(a: DD) -> DD:
    neg = a.hi < 0
    return DD(np.where(neg, -a.hi, a.hi), np.where(neg, -a.lo, a.lo))


def dd_powi(a: DD, n: int) -> DD:
    if n < 0:
        return dd_div(DD(1.0), dd_powi(a, -n))
    result = DD(np.ones_like(a.hi))
    base = a
    while n:
        if n & 1:
            result = dd_mul(result, base)
        base = dd_mul(base, base)
        n >>= 1
    return result


# -- constants -------------------------------------------------------------

def dd_pi() -> DD:
    return DD(3.141592653589793116, 1.2246467991473531772e-16)


def dd_2pi() -> DD:
    return dd_mul(DD(2.0), dd_pi())


def dd_e() -> DD:
    return DD(2.718281828459045091, 1.4456468917292502e-16)


def dd_from_string(s: str) -> DD:
    """Parse with ~32 significant digits (uses mpmath when available)."""
    try:
        import mpmath
        with mpmath.workdps(40):
            v = mpmath.mpf(s)
            hi = float(v)
            lo = float(v - mpmath.mpf(hi))
        return DD(hi, lo)
    except ImportError:
        return DD(float(s))


# -- transcendentals (argument-reduced Taylor; precompute-grade) ----------

def dd_cos(a: DD) -> DD:
    return _dd_sincos(a)[1]


def dd_sin(a: DD) -> DD:
    return _dd_sincos(a)[0]


def _dd_sincos(a: DD):
    """sin & cos via reduction mod pi/2 + Taylor on |x|<=pi/4.

    Accuracy ~1e-31 for |a| up to ~1e8 (enough for node generation).
    """
    half_pi = dd_div(dd_pi(), DD(2.0))
    k = np.round((a.hi + a.lo) / (half_pi.hi))
    x = dd_add(a, dd_neg(dd_mul(DD(k), half_pi)))
    # Taylor series for sin and cos on the reduced argument.
    x2 = dd_mul(x, x)
    s = DD(np.zeros_like(a.hi))
    c = DD(np.zeros_like(a.hi))
    # sin: sum (-1)^m x^(2m+1)/(2m+1)! ; cos: sum (-1)^m x^(2m)/(2m)!
    term_s = x
    term_c = DD(np.ones_like(a.hi))
    s = dd_add(s, term_s)
    c = dd_add(c, term_c)
    for m in range(1, 20):
        term_s = dd_mul(term_s, x2)
        term_s = dd_div(term_s, DD(-float(2 * m) * float(2 * m + 1)))
        s = dd_add(s, term_s)
        term_c = dd_mul(term_c, x2)
        term_c = dd_div(term_c, DD(-float(2 * m - 1) * float(2 * m)))
        c = dd_add(c, term_c)
    # rotate by k quadrants: (s,c) depends on k mod 4
    km = (k.astype(np.int64)) % 4
    sin_out_hi = np.select(
        [km == 0, km == 1, km == 2, km == 3],
        [s.hi, c.hi, -s.hi, -c.hi])
    sin_out_lo = np.select(
        [km == 0, km == 1, km == 2, km == 3],
        [s.lo, c.lo, -s.lo, -c.lo])
    cos_out_hi = np.select(
        [km == 0, km == 1, km == 2, km == 3],
        [c.hi, -s.hi, -c.hi, s.hi])
    cos_out_lo = np.select(
        [km == 0, km == 1, km == 2, km == 3],
        [c.lo, -s.lo, -c.lo, s.lo])
    return DD(sin_out_hi, sin_out_lo), DD(cos_out_hi, cos_out_lo)


# -- small dense linear algebra in DD (for precompute) --------------------

def dd_matmul(A: DD, B: DD) -> DD:
    """(m,k) @ (k,n) in DD, naive loops (precompute-only sizes)."""
    m, k = A.shape
    k2, n = B.shape
    assert k == k2
    out = DD.zeros((m, n))
    for i in range(m):
        for j in range(n):
            acc = DD(0.0)
            for l in range(k):
                acc = dd_add(acc, dd_mul(A[i, l], B[l, j]))
            out[i, j] = acc
    return out


def _split_slices(A: np.ndarray, axis: int, nslice: int = 3):
    """Exact slice decomposition of an f64 matrix for error-free GEMM
    (Ozaki-scheme splitting — Ozaki/Ogita/Oishi/Rump, "Error-free
    transformations of matrix multiplication", Numer. Algorithms 2012):
    A = sum(slices), where every entry of slice s is an integer
    multiple of a per-row (axis=1) or per-column (axis=0) power of two
    with <= 21 significant bits.  Slice-pair products then accumulate
    EXACTLY in a k<=2048 f64 GEMM: each addend |a*b| <= 2^21 * 2^21
    grid units, so a k-term sum reaches at most 2^42 * 2^11 = 2^53
    grid units inclusive — still exactly representable, with zero
    margin at k=2048 (per-factor bound |m| <= 2^21, not 2^21-1).
    The last slice is the raw remainder: its products against the
    leading slices are ~2^-42 of the result scale and their f64
    rounding ~2^-94 — below the DD target.

    Input range: the shift constant sigma = 2^(e+32) overflows to inf
    (NaN slices) when a row/column max exceeds ~2^991, and subnormal
    scales degrade the split; callers must keep row/column maxima of
    |A| within ~[2^-1000, 2^990] (asserted in ld_gemm)."""
    A = np.asarray(A, np.float64)
    mx = np.max(np.abs(A), axis=axis, keepdims=True)
    mx = np.where(mx > 0, mx, 1.0)
    # sigma = 2^(e+32): fl((A+sigma)-sigma) keeps bits down to
    # ulp(sigma) = 2^(e-20) -> <= 21-bit entries bounded by 2^e
    e2 = np.exp2(np.ceil(np.log2(mx)))
    out, rem = [], A
    for _ in range(nslice - 1):
        sigma = e2 * np.float64(2.0**32)
        hi = (rem + sigma) - sigma
        out.append(hi)
        # exact: the extraction property of Ozaki/Rump's ExtractScalar
        # (hi holds only bits >= ulp(sigma), so rem = A - hi is
        # computed without rounding)
        rem = rem - hi
        e2 = e2 * np.float64(2.0**-21)
    out.append(rem)
    return out


def ld_gemm(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Extended-precision (m,k)@(k,n) GEMM of longdouble/f64 matrices
    at BLAS speed: each longdouble splits exactly into hi+lo f64; the
    hi*hi product runs as 9 error-free sliced f64 GEMMs (exact
    accumulation — no f64 cancellation loss even under ~1/rcond
    amplification), cross terms as 2 plain GEMMs, all 11 partials
    summed elementwise in DD.  Replaces numpy's BLAS-less longdouble
    matmul (~100x slower) in the hiprec/QuadReal precompute paths
    (math_utils.hpp:236-300 precompute-in-QuadReal discipline).
    Accuracy: remainder-slice products are ~2^-42 of the result scale
    and their f64 rounding ~2^-94 normwise — matches naive longdouble
    matmul to ~1e-27 NORMWISE relative error (elementwise relative
    error under heavy cancellation can be far worse, as for any fixed-
    precision accumulation)."""
    k = A.shape[1]
    # k <= 2048: slice products reach at most 2^42 * 2^11 = 2^53 grid
    # units inclusive (see _split_slices) — representable, zero margin
    assert k == B.shape[0] and k <= 2048
    for M, ax in ((A, 1), (B, 0)):
        mx = np.max(np.abs(np.asarray(M, np.float64)), axis=ax)
        nz = mx[mx > 0]
        assert nz.size == 0 or (2.0**-1000 <= nz.min()
                                and nz.max() <= 2.0**990), \
            "ld_gemm row/col scale outside the exact-split range"
    Ah = np.asarray(A, np.float64)
    Bh = np.asarray(B, np.float64)
    if np.asarray(A).dtype == np.longdouble:
        Al = np.float64(A - Ah.astype(np.longdouble))
    else:
        Al = None
    if np.asarray(B).dtype == np.longdouble:
        Bl = np.float64(B - Bh.astype(np.longdouble))
    else:
        Bl = None
    As = _split_slices(Ah, axis=1)
    Bs = _split_slices(Bh, axis=0)
    parts = [a @ b for a in As for b in Bs]        # leading ones exact
    if Bl is not None:
        parts.append(Ah @ Bl)
    if Al is not None:
        parts.append(Al @ Bh)
    acc = DD(parts[0])
    for p in parts[1:]:
        acc = dd_add(acc, DD(p))
    return acc.hi.astype(np.longdouble) + acc.lo.astype(np.longdouble)


def dd_solve(A: DD, b: DD) -> DD:
    """Solve A x = b by Gaussian elimination w/ partial pivoting in DD.

    A: (n,n) DD, b: (n,m) DD.  Precompute-only sizes (n <= ~64).
    """
    n = A.shape[0]
    m = b.shape[1] if len(b.shape) > 1 else 1
    Ah, Al = A.hi.copy(), A.lo.copy()
    bh = b.hi.reshape(n, m).copy()
    bl = b.lo.reshape(n, m).copy()
    Aw = DD(Ah, Al)
    bw = DD(bh, bl)
    for col in range(n):
        # pivot
        piv = col + int(np.argmax(np.abs(Aw.hi[col:, col])))
        if piv != col:
            for arr in (Aw.hi, Aw.lo, bw.hi, bw.lo):
                arr[[col, piv]] = arr[[piv, col]]
        inv_p = dd_div(DD(1.0), Aw[col, col])
        for row in range(col + 1, n):
            f = dd_mul(Aw[row, col], inv_p)
            for c2 in range(col, n):
                Aw[row, c2] = dd_add(Aw[row, c2],
                                     dd_neg(dd_mul(f, Aw[col, c2])))
            for c2 in range(m):
                bw[row, c2] = dd_add(bw[row, c2],
                                     dd_neg(dd_mul(f, bw[col, c2])))
    x = DD.zeros((n, m))
    for row in range(n - 1, -1, -1):
        for c2 in range(m):
            acc = bw[row, c2]
            for c3 in range(row + 1, n):
                acc = dd_add(acc, dd_neg(dd_mul(Aw[row, c3], x[c3, c2])))
            x[row, c2] = dd_div(acc, Aw[row, row])
    return x
