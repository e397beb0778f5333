"""The generator repeats from a seed, finds each law by name, and the
traffic's inputs are the ones the cells state."""

import json

import numpy as np
import pytest
import torch

from portbench import generate, harness

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_points_repeat(seed):
    spec = {"law": "uniform_cube", "n": 500}
    a = generate.points(spec, seed, "cpu")
    b = generate.points(spec, seed, "cpu")
    assert torch.equal(a, b)
    assert a.shape == (500, 3) and a.dtype == torch.float64
    assert float(a.min()) >= 0 and float(a.max()) < 1
    assert not torch.equal(a, generate.points(spec, seed + 1, "cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_densities_repeat_by_index(seed):
    spec = {"law": "normal"}
    d = lambda s, i: generate.densities(spec, seed, s, i, 300, 3, "cpu",
                                        torch.float32)
    assert torch.equal(d("density", 4), d("density", 4))
    assert not torch.equal(d("density", 4), d("density", 5))
    assert not torch.equal(d("density", 0), d("warm", 0))


def test_sample_repeats_and_is_distinct():
    a = generate.sample(2 ** 31 + 1, 10_000, 1024)
    assert np.array_equal(a, generate.sample(2 ** 31 + 1, 10_000, 1024))
    assert len(np.unique(a)) == 1024 and a.max() < 10_000


def test_point_set_is_the_same_for_every_seed():
    spec = {"law": "uniform_cube", "n": 400, "set": 5}
    assert torch.equal(generate.points(spec, 1, "cpu"),
                       generate.points(spec, 2 ** 31 + 9, "cpu"))


def test_traffic_files_parse_and_name_laws_that_exist():
    for path in (harness.ROOT / "traffic").glob("*.json"):
        trf = json.loads(path.read_text())
        assert trf["name"] == path.stem
        for key in ("points", "densities"):
            assert callable(generate.law(trf[key]["law"]))


def test_unknown_law_is_refused():
    with pytest.raises(ValueError, match="unknown law"):
        generate.points({"law": "no_such_law", "n": 10}, 1, "cpu")
