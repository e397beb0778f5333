"""The check sees a broken timed path.  Each test drives a whole run of
the cell on the CPU at a small size (the look for a card skipped, the
program's plain kernels), once sound and once with the timed path
broken underneath, and sees `correct` come out true, then false: an
evaluation that returns its state unchanged, one that leaves half of
its answers out, one whose answers are altered where they are
produced.  The cells run on one card, so no exchange between cards can
be left out.  At these sizes the program's own accuracy is coarser
than at the cells' sizes, so the limits are the tests' own."""

import pytest
import torch

from portbench import harness

KIFMM = "laplace_kifmm_p6_f32.uniform_1e7"
KIFMM_SMALL = {"config": {"p": 4, "depth": 2, "limits": {"rel_err": 2e-3}},
               "traffic": {"points": {"law": "uniform_cube", "n": 3000}}}


def _kifmm_fault(kind):
    from sctl_tpu_torch.fmm.kifmm import KIFMM as K
    sound = K.eval_tensor
    last = {}

    def broken(self, f):
        u = sound(self, f)
        if kind == "unchanged":                 # the previous answer again
            out = last.get("u", torch.zeros_like(u))
        elif kind == "half":                    # half of the targets left out
            out = u.clone()
            out[1::2] = 0
        else:                                   # altered where produced
            out = u * 1.01
        last["u"] = u
        return out
    return broken


@pytest.fixture(scope="module")
def threads():
    from sctl_tpu_torch.config import limit_cpu_threads
    limit_cpu_threads(2)


def test_kifmm_sound(threads):
    res, _ = harness.run_cell(KIFMM, 2 ** 31 + 3, 0.5, False, "cpu",
                              overrides=KIFMM_SMALL)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_kifmm_fault_fails(threads, monkeypatch, kind):
    from sctl_tpu_torch.fmm.kifmm import KIFMM as K
    monkeypatch.setattr(K, "eval_tensor", _kifmm_fault(kind))
    res, _ = harness.run_cell(KIFMM, 2 ** 31 + 3, 0.5, False, "cpu",
                              overrides=KIFMM_SMALL)
    assert res["attempted"] >= 2
    assert not res["correct"], res["checks"]
