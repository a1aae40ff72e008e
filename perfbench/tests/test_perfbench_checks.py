"""``correct`` fails when it should: the control in the program's place,
and the timed path broken underneath a run (a step that returns its state
unchanged: the registrations, the pose-graph solve; an answer altered where
it is produced).  The cell runs on the CPU at the size of ``cpu_cells``;
each test runs the harness's runner and checks end to end, and skips only
the look for a card.  The cell holds one scan a call on one chip: no batch
to halve, no exchange between chips to leave out.

The drift and the pose-graph solve are held to limits of the test size
(PERF.md: sound runs there read a 2-s drift of 0.010-0.018 m, the control
0.072 m; a solve cost share of 0.0019-0.021, where the plain float32 route
runs, against 1.0 for a solve that returns its start); the other checks are
the cell's own."""
import pytest
import torch

import cpu_cells

MAPPING_LIMITS = {"drift_2s_median_m": 0.035, "solve_cost_share": 0.2}
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _mapping(**kw):
    return cpu_cells.run(cpu_cells.MAPPING, SEED, 40.0, checks=MAPPING_LIMITS, **kw)


def _values(out):
    return {c["name"]: c["value"] for c in out["checks"]}


def _limits(out):
    return {c["name"]: c["limit"] for c in out["checks"]}


def test_a_sound_mapping_run_is_correct():
    out = _mapping()
    assert out["correct"], (out["checks"], out["info"])
    assert out["attempted"] >= 1


def test_the_mapping_control_is_not_correct():
    out = _mapping(plant="control")
    assert not out["correct"], out["checks"]
    assert _values(out)["drift_2s_median_m"] > MAPPING_LIMITS["drift_2s_median_m"]


@pytest.mark.parametrize("fault", ["registrations_unchanged", "poses_altered",
                                   "solve_unchanged"])
def test_a_broken_mapping_run_is_not_correct(fault):
    out = _mapping(plant=fault)
    assert not out["correct"], out["checks"]
    if fault == "solve_unchanged":
        assert _values(out)["solve_cost_share"] > _limits(out)["solve_cost_share"]
