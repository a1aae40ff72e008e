"""Port vs JAX: a short ``SlamWrapper`` replay with undistortion and loop
closures on (the configuration users run), on the simulated VLP-16 scans of
``tests/test_torch_slice.py``.

Undistortion runs in both stages with the velocity of the pose buffers as
they stand at dispatch; the submaps that finish get their features and their
odometry constraints queued, then read in ``finish_processing``.  No revisit
happens in six scans (``tests/test_torch_loop_closure.py`` holds the closure
itself).  Tolerances are those of the slice replay: 3 mm and 2 mrad per
pose; the constraints' correspondence counts, read from submaps built from
those poses, to 2%.
"""
import numpy as np
import pytest

from open3d_slam_tpu.models.slam_wrapper import SlamWrapper as JaxSlamWrapper
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.ops import motion_compensation as tmc

import test_torch_slice as slice_tests
from torch_parity import JaxScores, jax_kernel_path, to_torch_params


def _params():
    p = slice_tests._params()
    p.motion_compensation.is_undistort_input_cloud = True
    p.motion_compensation.num_poses_velocity_estimation = 2
    p.mapper.is_attempt_loop_closures = True
    p.mapper.submaps.min_seconds_between_feature_computation = 0.0
    p.capacities.feature_cloud = 1024
    return p


@pytest.fixture(scope="module")
def replays(scans):
    pts, ts, _ = scans
    jp = _params()
    with jax_kernel_path():
        jslam = JaxSlamWrapper(jp)
        for s, t in zip(pts, ts):
            jslam.process_scan_pipelined(s, t)
        jslam.finish_processing()
    tslam = SlamWrapper(to_torch_params(jp), device="cpu")
    tslam.odometry.draw_scores = JaxScores(0)
    tslam.mapper.scan_to_map_reg.draw_scores = JaxScores(1)
    undistort, calls = tmc.undistort_constant_velocity, []
    tmc.undistort_constant_velocity = lambda *a, **k: calls.append(1) or undistort(*a, **k)
    try:
        for s, t in zip(pts, ts):
            tslam.process_scan_pipelined(s, t)
        tslam.finish_processing()
    finally:
        tmc.undistort_constant_velocity = undistort
    tslam.n_undistorted = len(calls)
    return jslam, tslam


scans = slice_tests.scans


def test_undistorted_replay_matches_jax(replays):
    jslam, tslam = replays
    t_j, p_j = jslam.get_trajectory()
    t_p, p_p = tslam.get_trajectory()
    assert t_p == t_j
    # Each stage undistorts once its pose buffer holds 3 poses: the
    # odometry's for scans 3-5, the mapper's (which fills later) after that.
    assert tslam.n_undistorted > 3
    slice_tests._assert_close_poses(p_p, p_j)
    assert tslam.get_health() == {**jslam.get_health(),
                                  "n_map_points": tslam.get_health()["n_map_points"]}


def test_closure_stages_run_with_the_replay(replays):
    """Finished submaps got features and queued odometry constraints, all
    read by the end; the closure job found nothing to match."""
    jslam, tslam = replays
    assert tslam.get_health()["n_submaps"] >= 3
    assert tslam._pending_constraint_pulls == [] and tslam._lc_job is None
    got = tslam.odometry_constraints
    want = jslam.odometry_constraints
    assert [(c.source_submap_idx, c.target_submap_idx) for c in got] == \
        [(c.source_submap_idx, c.target_submap_idx) for c in want]
    assert got, "no odometry constraint was built"
    for c, d in zip(got, want):
        np.testing.assert_array_equal(c.source_to_target, np.eye(4))
        assert abs(c.information_matrix[5, 5] - d.information_matrix[5, 5]) <= \
            0.02 * d.information_matrix[5, 5]
    for s in tslam.submaps.submaps[:-1]:
        assert s.fpfh is not None and s.fpfh.shape == (1024, 33)
    assert tslam.get_health()["n_loop_closures_accepted"] == 0
    assert tslam.num_latest_loop_closure_constraints == jslam.num_latest_loop_closure_constraints


def test_mapping_cli_undistort_on_cpu(tmp_path):
    """``--undistort`` through the CLI on the CPU at small capacities, with
    the repo's default configuration (loop closures on)."""
    from open3d_slam_torch.cli import mapping as tcli
    from open3d_slam_torch.utils import config as tcfg
    import json
    param = tmp_path / "small.yaml"
    param.write_text(
        "include: {}\n"
        "capacities: {{raw_scan: 32768, processed_scan: 1024, map_patch: 2048, "
        "submap_points: 8192, feature_cloud: 1024, max_submaps: 16, "
        "max_constraints: 32}}\n"
        "odometry: {{scan_processing: {{voxel_size: 0.6}}, scan_matcher: {{icp: "
        "{{max_num_iter: 8, knn: 8, max_distance_knn: 1.5}}}}}}\n"
        "mapper: {{is_print_timing_statistics: false, scan_processing: "
        "{{voxel_size: 0.6}}, map_builder: {{map_voxel_size: 0.6}}, submaps: "
        "{{radius: 3.0, min_num_range_data: 2}}, scan_matcher: "
        "{{min_refinement_fitness: 0.1, icp: {{max_num_iter: 8, knn: 8, "
        "max_distance_knn: 1.5}}}}}}\n".format(tcfg.config_path("default.yaml")))
    out = tmp_path / "eval.json"
    assert tcli.main(["--synthetic", "9", "--device", "cpu", "--param", str(param),
                      "--undistort", "--eval-json", str(out)]) == 0
    metrics = json.loads(out.read_text())
    assert "--undistort" in metrics["argv"] and metrics["n_poses"] == 4
    assert np.isfinite(metrics["ate_rmse_m"])
    assert metrics["n_submaps"] >= 2
    assert metrics["n_loop_closures_accepted"] >= 0 and "n_optimizations_applied" in metrics
