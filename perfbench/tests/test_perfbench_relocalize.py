"""The relocalization cell: its files name each other, a run without the
program's entry point stops before it renders, and ``correct`` fails when it
should.  The cell runs on the CPU at the size of ``relocalize_cells``, end to
end through the harness's runner, generator, reference and checks.

At the test size the 16 hypotheses lie at one corner of the map and find no
query (``localized_share`` reads 0 there, and is held to 0); the other
checks are held to limits of the test size (PERF.md: a sound run reads a
final-stage gap of 6.5e-4 m, coarse and mid gaps of
1.1e-6 m and 8.9e-7 m, rank and fitness gaps of 6.4e-8 and less, a scan gap
of 0; the control a final-stage gap of 0.094 m, a mid gap of 0.149 m and a
coarse gap of 5.6e-3 m, the faults a final-stage gap of 0.043 m and more, a
mid gap of 2.2 m, a fitness gap of 3.0e-3, a rank gap of 1.4e-3 or a scan
gap of 0.012 m)."""
import pytest
import torch

import relocalize_cells
from perfbench import core

CELL = relocalize_cells.RELOCALIZE
LIMITS = {"localized_share": 0.0, "coarse_pose_gap_m": 1e-4, "mid_pose_gap_m": 1e-4,
          "rank_score_gap_max": 1e-4, "final_pose_gap_m": 5e-3, "fitness_gap_max": 1e-4}
SEED = 2**31 + 77
NEW_METRICS = ("relocalize.prep_ms_per_query", "relocalize.sweep_ms_per_query",
               "relocalize.mid_ms_per_query", "relocalize.idle_ms_per_query",
               "relocalize.host_syncs_per_query", "kernels.device_ms.relocalize",
               "device.idle_share.relocalize")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_the_cell_files_name_each_other():
    bench = core.benchmark()
    files = core.cell_files(bench, CELL)
    assert files["config_entry"]["file"] == "perfbench/configs/vlp16_relocalize.json"
    assert files["config"]["name"] == files["cell"]["config"] == "vlp16_relocalize"
    assert core.runner(files["config"]).__name__.endswith("runners.relocalize")
    assert core.generator(files["traffic"]).__name__ == "kidnapped"
    mapper = files["config"]["slam_parameters"]["mapper"]
    assert mapper["is_use_initial_map"] and not mapper["is_merge_scans_into_map"]
    assert not mapper["is_attempt_loop_closures"]
    assert set(files["checks"]) == {"localized_share", "coarse_pose_gap_m", "mid_pose_gap_m",
                                    "rank_score_gap_max", "final_pose_gap_m",
                                    "fitness_gap_max", "scan_gap_m"}
    reported = {m["name"] for m in core.metrics_of(bench, CELL, trace=True)}
    assert reported == set(NEW_METRICS)
    assert {m["name"] for m in core.metrics_of(bench, CELL, trace=False)} == {
        "scans_per_s", "scan_p95_ms", "setup_s"}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_reader_reads_only_a_relocalization_trace(name):
    read = core.metric_reader(name)
    assert read({}) is None
    assert read({"kind": "mapping", "spans": {}, "profiled_scans": 10}) is None
    trace = {"kind": "relocalize", "synced_queries": 4, "profiled_queries": 5,
             "stage_ms": {"prep": 40.0, "coarse": 8.0, "rank": 12.0, "mid": 4.0, "refine": 16.0,
                          "final": 4.0},
             "idle_ms_by_stage": {"prep": 10.0, "query": 5.0}, "host_syncs": 50,
             "profile": {"hand_written_ms": 20.0, "busy_s": 3.0, "window_s": 4.0}}
    want = {"relocalize.prep_ms_per_query": 10.0, "relocalize.sweep_ms_per_query": 10.0,
            "relocalize.mid_ms_per_query": 1.0, "relocalize.idle_ms_per_query": 3.0,
            "relocalize.host_syncs_per_query": 10.0, "kernels.device_ms.relocalize": 4.0,
            "device.idle_share.relocalize": 0.25}
    assert read(trace) == pytest.approx(want[name])


def test_a_program_without_the_entry_point_stops_before_it_renders(monkeypatch):
    from open3d_slam_torch.models.map_initializer import SlamMapInitializer
    from perfbench.generators import relocalize as gen
    monkeypatch.delattr(SlamMapInitializer, "relocalize")
    monkeypatch.setattr(gen, "kidnapped", lambda *a: pytest.fail("rendered"))
    with pytest.raises(SystemExit) as stop:
        relocalize_cells.run(SEED, 1.0)
    assert stop.value.code == 2


def _values(out):
    return {c["name"]: c["value"] for c in out["checks"]}


def test_a_sound_relocalization_run_is_correct():
    out = relocalize_cells.run(SEED, 0.5, checks=LIMITS)
    assert out["correct"], (out["checks"], out["info"])
    assert out["attempted"] >= 1


@pytest.mark.parametrize("fault,check", [
    ("control", "final_pose_gap_m"), ("unrefined", "final_pose_gap_m"),
    ("mid_skipped", "mid_pose_gap_m"), ("final_skipped", "final_pose_gap_m"), ("map_bf16", "rank_score_gap_max"),
    ("refine_fitness", "fitness_gap_max"), ("scan_bf16", "scan_gap_m")])
def test_a_broken_relocalization_run_is_not_correct(fault, check):
    out = relocalize_cells.run(SEED, 0.5, plant=fault, checks=LIMITS)
    assert not out["correct"], out["checks"]
    limit = {c["name"]: c["limit"] for c in out["checks"]}[check]
    assert _values(out)[check] > limit
