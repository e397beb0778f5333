"""The device's busy time is the union of its activity intervals, and
the per-layer readers read what the traced run recorded."""

import pytest

from portbench import harness, trace


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (30, 35), (40, 41), (2, 3)]
    assert trace.union(iv) == [[0, 15], [20, 35], [40, 41]]


def test_busy_and_gaps_clipped_to_window():
    iv = [(0, 10), (5, 15), (20, 30), (25, 28), (90, 120)]
    busy, gaps = trace.busy_and_gaps(iv, 2, 100)
    assert busy == (15 - 2) + (30 - 20) + (100 - 90)
    assert gaps == [(15, 20), (30, 90)]
    busy, gaps = trace.busy_and_gaps([], 0, 10)
    assert busy == 0 and gaps == [(0, 10)]


def test_idle_share_reader():
    read = harness.metric_reader("device.idle_share.kifmm")
    assert read({"device": {"busy_s": 3.0, "window_s": 4.0}}) == 25.0
    assert read({"device": None}) is None
    assert read({"device": {"busy_s": 1.0, "window_s": 1.0}}) == 0.0


def _calls():
    # two timed calls of two stage sets each
    a = {"S2M": 1.0, "M2M": 2.0, "M2L": 3.0, "L2L": 4.0, "L2T": 5.0,
         "P2P near": 6.0, "P2P sidebands": 7.0}
    b = {k: 2 * v for k, v in a.items()}
    return [[a, b], [b, a]]


@pytest.mark.parametrize("name, value", [
    ("kifmm.far_ms", 1.5 * 15.0), ("kifmm.near_ms", 1.5 * 13.0)])
def test_stage_readers(name, value):
    read = harness.metric_reader(name)
    assert read({"calls": _calls()}) == pytest.approx(value)
    assert read({"calls": []}) is None


def test_pair_stages_roofline_reader():
    read = harness.metric_reader("pair_stages_roofline")
    # S2M + L2T + near + sidebands: 19 ms, then 38 ms: mean 28.5 ms
    data = {"calls": _calls(), "work": {"bound_s": 2.85e-3}}
    assert read(data) == pytest.approx(10.0)
    assert read({"calls": _calls()}) is None
