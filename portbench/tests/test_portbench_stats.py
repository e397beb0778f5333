"""Window statistics: the tail over every sample, a rate or a mean
over whole calls of the whole window; the kernel build timed apart."""

import time
import types

import pytest

from portbench import harness
from portbench.stats import percentile, spread

KIFMM = "laplace_kifmm_p6_f32.uniform_1e7"


def test_p95_nearest_rank_over_all_samples():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95
    assert percentile(vals[::-1], 95) == 95
    assert percentile([5.0], 95) == 5.0
    # 450 samples: 23 lie above the 95th percentile
    vals = [float(i) for i in range(450)]
    p = percentile(vals, 95)
    assert sum(v > p for v in vals) == 22 and sum(v >= p for v in vals) == 23


def test_spread_quartiles_over_median():
    assert spread([1.0, 1.0, 1.0, 1.0]) == 0
    s = spread([0.9, 1.0, 1.1, 1.0, 1.0, 0.95])
    assert 0 < s < 0.2


class _SleepCell:
    """A driver whose calls take a fixed time."""

    def __init__(self, cfg, trf, seed, device):
        self.dt = cfg["call_s"]
        self.n = 1000                   # points an evaluation

    def prepare(self, i):
        return i

    def call(self, inp, marks):
        time.sleep(self.dt)
        return inp

    def keep(self, i, inp, out):
        pass

    def failed(self):
        return 0

    def release(self):
        pass

    def end_to_end(self, times, window_s):
        from portbench.drivers.kifmm import Cell
        return Cell.end_to_end(self, times, window_s)

    def checks(self):
        return []

    def layer_data(self):
        return {}


@pytest.mark.parametrize("seconds", [0.05, 0.33])
def test_window_holds_whole_calls(monkeypatch, seconds):
    monkeypatch.setattr(harness, "driver", lambda kind: types.SimpleNamespace(
        Cell=_SleepCell))
    res, info = harness.run_cell(
        KIFMM, 1, seconds, False, "cpu", overrides={"config": {"call_s": 0.1}})
    n = res["attempted"]
    # the window runs until --seconds have passed and the last call
    # ends: it stops at the first call that ends past them
    assert info["window_s"] >= seconds
    assert info["window_s"] - info["call_s_max"] < seconds
    assert info["window_s"] >= n * 0.1
    # points_per_s: every evaluation's points over the window's time;
    # eval_ms_p95: the tail of every evaluation
    assert res["metrics"]["points_per_s"]["value"] == pytest.approx(
        n * 1000 / info["window_s"])
    assert res["metrics"]["eval_ms_p95"]["value"] >= 100.0
    assert set(res["metrics"]) == {"points_per_s", "eval_ms_p95",
                                   "setup_s"}
    assert res["correct"] and res["failed"] == 0


def test_build_timed_apart_names_what_it_compiled(monkeypatch, tmp_path):
    from sctl_tpu_torch import native
    from sctl_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_SO", tmp_path / "native.so")
    (tmp_path / "native.so").write_bytes(b"")      # built before
    lib = tmp_path / _build.LIB_NAME
    monkeypatch.setattr(_build, "library",   # builds where missing
                        lambda: lib.exists() or lib.write_bytes(b""))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    b = harness.build_kernels()
    assert b["built"] == ["kernels"] and b["build_s"] >= 0
    assert harness.build_kernels()["built"] == []
