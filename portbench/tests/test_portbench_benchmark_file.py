"""BENCHMARK.json keeps to the benchmark's contract, and every name in
it is found: a configuration by its file, a mix by `traffic/<mix>.json`,
a per-layer metric by `metrics/<metric>.py`, a kind by its driver."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s

B = harness.benchmark()


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (harness.CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert 1 <= len(B["command"]) <= 32 and all(TEXT(w) for w in
                                                 B["command"])
    for p in B["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert (harness.CHECKOUT / p).is_dir() and ".." not in p


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT(c["source"]) and TEXT(c["why"])
        assert c["name"] in used
        assert c["file"].startswith(B["paths"][0] + "/")
        cfg = json.loads((harness.CHECKOUT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        harness.driver(cfg["kind"]).Cell


def test_workloads():
    names = [w["name"] for w in B["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(names)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT(w["why"])
        assert (harness.ROOT / "traffic" / f"{w['traffic']}.json").exists()


def _metrics():
    return B["end_to_end"] + B["per_layer"]


def test_metric_names_units_and_keys():
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in B["workloads"]}
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT(m["layer"]) and m["moves"] in e2e
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        # every cell the metric lists reports the metric it moves
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m for m in B["end_to_end"] if harness.applies(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(harness.applies(m, cell) for m in B["per_layer"])
