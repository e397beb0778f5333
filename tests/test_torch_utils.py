"""The port's utilities against the JAX package's: the parallel
primitives exactly, a checkpoint of nested tensors and a KrylovPrecond
round trip bit for bit, the debug guards raising as the JAX ones do;
and the port and chip_smoke.py import neither JAX nor the JAX package."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.config import config as j_config
from sctl_tpu.linalg import KrylovPrecond as J_KP
from sctl_tpu.linalg import gmres as j_gmres
from sctl_tpu.utils import debug as j_debug
from sctl_tpu.utils import merge as j_merge
from sctl_tpu.utils import merge_sort as j_merge_sort
from sctl_tpu.utils import reduce as j_reduce
from sctl_tpu.utils import scan as j_scan
from sctl_tpu_torch import config
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import KrylovPrecond, gmres
from sctl_tpu_torch.utils import checkpoint, debug, merge, merge_sort, \
    reduce, scan

limit_cpu_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_par_matches_jax(dtype):
    rng = np.random.default_rng(0)
    a = np.sort(rng.integers(-50, 50, 20)).astype(dtype)
    b = np.sort(rng.integers(-50, 50, 31)).astype(dtype)
    x = rng.integers(-9, 9, 40).astype(dtype)
    keys = rng.integers(0, 5, 40).astype(dtype)
    T, J = torch.as_tensor, jnp.asarray
    same = lambda p, j: np.testing.assert_array_equal(
        np.asarray(p), np.asarray(j).astype(dtype))
    same(merge(T(a), T(b)), j_merge(J(a), J(b)))
    same(merge_sort(T(x)), j_merge_sort(J(x)))
    for p, j in zip(merge_sort(T(x), T(keys)), j_merge_sort(J(x), J(keys))):
        same(p, j)
    for op in ("sum", "max", "min", "prod"):
        same(reduce(T(x[:12]), op), j_reduce(J(x[:12]), op))
    for op in ("sum", "max", "min"):
        for exclusive in (True, False):
            if dtype == "int64" and exclusive and op != "sum":
                continue        # JAX writes an int -inf / inf identity
            same(scan(T(x), op, exclusive), j_scan(J(x), op, exclusive))
    assert scan(T(x), "max")[0] == torch.iinfo(torch.int64).min \
        if dtype == "int64" else scan(T(x), "max")[0] == -np.inf


def test_checkpoint_round_trip(tmp_path):
    """Nested dicts, lists and tuples of tensors and numbers come back
    bit for bit; like= moves them to like's devices and checks the
    structure."""
    g = torch.Generator().manual_seed(1)
    tree = {"a": torch.randn(8, generator=g, dtype=torch.float64),
            "b": [torch.ones((3, 2), dtype=torch.float32),
                  (torch.tensor(2.5), torch.arange(5))], "n": 7}
    p = str(tmp_path / "state")
    checkpoint.save(p, tree)
    back = checkpoint.restore(p)
    assert back["n"] == 7 and isinstance(back["b"][1], tuple)
    for x, y in ((tree["a"], back["a"]), (tree["b"][0], back["b"][0]),
                 (tree["b"][1][0], back["b"][1][0]),
                 (tree["b"][1][1], back["b"][1][1])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    like = checkpoint.restore(p, like=tree)
    assert torch.equal(like["b"][1][1], tree["b"][1][1])
    with pytest.raises(ValueError):
        checkpoint.restore(p, like={"a": tree["a"]})


def test_krylov_precond_round_trip(tmp_path):
    """A KrylovPrecond collected by the host gmres, saved and restored:
    its pairs bit for bit, and the restored one gives the same second
    solve (iterations of the JAX package's, which restores its own)."""
    rng = np.random.default_rng(7)
    N = 80
    A = rng.random((N, N)) / N + np.eye(N)
    b, b2 = rng.random(N), rng.random(N)
    At = torch.as_tensor(A)
    kp = KrylovPrecond()
    gmres(lambda v: At @ v, torch.as_tensor(b), tol=1e-10, krylov_precond=kp)
    p = str(tmp_path / "kp")
    checkpoint.save_krylov_precond(p, kp)
    kp2 = checkpoint.restore_krylov_precond(p)
    assert (kp2.size(), kp2.rank()) == (kp.size(), kp.rank()) and kp.rank()
    for (q1, u1), (q2, u2) in zip(kp._pairs, kp2._pairs):
        assert torch.equal(q1, q2) and torch.equal(u1, u2)
    x1, it1 = gmres(lambda v: At @ v, torch.as_tensor(b2), tol=1e-10,
                    krylov_precond=kp)
    x2, it2 = gmres(lambda v: At @ v, torch.as_tensor(b2), tol=1e-10,
                    krylov_precond=kp2)
    assert it1 == it2 and torch.equal(x1, x2)
    jkp = J_KP()
    Aj = jnp.asarray(A)
    j_gmres(lambda v: Aj @ v, jnp.asarray(b), tol=1e-10, krylov_precond=jkp)
    _, jit2 = j_gmres(lambda v: Aj @ v, jnp.asarray(b2), tol=1e-10,
                      krylov_precond=jkp)
    assert it2 == jit2


@pytest.fixture
def debug_on():
    j_config.debug = config.debug = True
    yield
    j_config.debug = config.debug = False


def test_guards_raise_as_jax(debug_on):
    """check_finite, guard and shape_contract raise where the JAX ones
    do, with the same exception types."""
    bad = np.array([1.0, np.nan])
    for chk, arr in ((debug.check_finite, torch.as_tensor),
                     (j_debug.check_finite, jnp.asarray)):
        chk(arr(np.ones(2)))
        with pytest.raises(FloatingPointError):
            chk(arr(bad), "x")
    for mod, arr in ((debug, torch.as_tensor), (j_debug, jnp.asarray)):
        g = mod.guard(lambda x: x * 2)
        g(arr(np.ones(3)))
        with pytest.raises(FloatingPointError):
            g(arr(bad))

        @mod.shape_contract(a=("N", 3, "float"), b=("N", None))
        def f(a, b):
            return a.sum() + b.sum()

        f(arr(np.ones((5, 3))), arr(np.ones((5, 2))))
        for a, b in (((5, 3), (4, 2)), ((5, 2), (5, 2)), ((5, 3, 1), (5, 2))):
            with pytest.raises(ValueError):
                f(arr(np.ones(a)), arr(np.ones(b)))
        with pytest.raises(ValueError):
            f(arr(np.ones((5, 3), np.int32)), arr(np.ones((5, 2))))


def test_guards_off_without_debug():
    config.debug = False
    assert debug.check_finite(torch.tensor([np.nan])).isnan().all()

    @debug.shape_contract(a=("N", 3))
    def f(a):
        return a.sum()
    assert float(f(torch.ones(4, 2))) == 8.0


def test_checked_call_and_nan_trap():
    """checked_call: an index past the extent raises before the gather
    runs (plain torch would read it as a negative index or fault on the
    card), a NaN made by a call and an integer division by zero raise;
    enable_nan_debugging traps a NaN at the call that made it."""
    x = torch.arange(4.0)
    assert float(debug.checked_call(lambda a, i: a[i], x, 2)) == 2.0
    for fn, args in ((lambda a, i: a[i], (x, 7)),
                     (lambda a, i: a[i], (x, torch.tensor([0, 4]))),
                     (lambda a, i: a.index_select(0, i),
                      (x, torch.tensor([5]))),
                     (lambda a, i: torch.gather(a, 0, i),
                      (x, torch.tensor([-5]))),
                     (lambda a, i: a.index_add_(0, i, torch.ones(1)),
                      (x.clone(), torch.tensor([9])))):
        with pytest.raises(IndexError):
            debug.checked_call(fn, *args)
    with pytest.raises(FloatingPointError):
        debug.checked_call(lambda a: torch.log(a - 2.0), x)
    with pytest.raises(ZeroDivisionError):
        debug.checked_call(lambda a, b: a // b, torch.arange(3),
                           torch.tensor([1, 0, 2]))
    debug.enable_nan_debugging(True)
    try:
        torch.ones(2) + 1.0
        with pytest.raises(FloatingPointError):
            torch.zeros(2) / torch.zeros(2)
    finally:
        debug.enable_nan_debugging(False)
    assert torch.isnan(torch.zeros(1) / torch.zeros(1)).all()
    debug.install_traceback()


def _imports(path):
    """The top-level module names a Python file imports."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of sctl_tpu_torch, and not chip_smoke.py, imports jax,
    jaxlib or sctl_tpu (relative imports stay inside the port)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "sctl_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 40
    bad = {f: n for f in files for n in _imports(f)
           if n in ("jax", "jaxlib", "sctl_tpu")}
    assert not bad, bad
