"""Port vs JAX over the whole slice: LidarOdometry and a short SlamWrapper
replay on simulated VLP-16 scans, pipelined vs sequential replay, the
interop round trip, the flags the first slice refused (all accepted now), the
mapping CLI, and the rule that the port imports nothing of JAX.

The JAX package runs on its kernel path (``torch_parity.jax_kernel_path``)
and hands its random-downsample draws to the port.  What remains between the
two is float32 round-off in other summation orders, which Gauss-Newton
carries from scan to scan.  Measured over these scans it stays below 1 mm
and 0.7 mrad per pose, so the tests allow 3 mm and 2 mrad (the map voxel is
0.4 m, the correspondence distance 1 m).
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from open3d_slam_tpu.io import lidar_sim
from open3d_slam_tpu.models.odometry import LidarOdometry as JaxOdometry
from open3d_slam_tpu.models.slam_wrapper import SlamWrapper as JaxSlamWrapper
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.cli import mapping as tcli
from open3d_slam_torch.models.odometry import LidarOdometry
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.utils import config as tcfg, device as tdevice, interop

from torch_parity import (JaxScores, jax_kernel_path, pose_errors,
                          small_jax_params, to_torch_params)

TRANS_TOL_M = 3e-3
ROT_TOL_RAD = 2e-3
N_SCANS = 6


@pytest.fixture(scope="module")
def scans():
    """The first scans of the simulated VLP-16 yard circle, every 4th return
    (~5300 points a scan), so both packages run in seconds on the CPU."""
    spec = dataclasses.replace(lidar_sim.BENCHMARK_SEQUENCES["vlp16_yard_circle"],
                               n_scans=N_SCANS)
    seq = lidar_sim.make_sim_sequence(spec, cache_dir="")
    return [s[::4] for s in seq.scans], list(seq.timestamps), seq.ground_truth


def _params():
    p = small_jax_params(ratio=0.5)
    p.capacities.raw_scan = 8192
    for o in (p.odometry, p.mapper):
        o.scan_processing.voxel_size = 0.3
        o.scan_matcher.icp.max_num_iter = 30
    # Submaps small enough that six scans switch submaps and replay the
    # overlap buffer; carving every third scan.
    p.mapper.submaps.radius = 1.0
    p.mapper.submaps.min_num_range_data = 2
    p.mapper.submaps.num_scans_overlap = 2
    p.mapper.map_builder.carving.carve_space_every_n_scans = 3
    return p


def _torch_slam(params, pipelined, scans, timestamps):
    slam = SlamWrapper(params, device="cpu")
    slam.odometry.draw_scores = JaxScores(0)
    slam.mapper.scan_to_map_reg.draw_scores = JaxScores(1)
    for s, t in zip(scans, timestamps):
        (slam.process_scan_pipelined if pipelined else slam.process_scan)(s, t)
    slam.finish_processing()
    return slam


@pytest.fixture(scope="module")
def replays(scans):
    """The same scans through the JAX SlamWrapper (pipelined) and the port's
    (pipelined and sequential)."""
    pts, ts, _ = scans
    jp = _params()
    with jax_kernel_path():
        jslam = JaxSlamWrapper(jp)
        for s, t in zip(pts, ts):
            jslam.process_scan_pipelined(s, t)
        jslam.finish_processing()
    tp = to_torch_params(jp)
    return jslam, _torch_slam(tp, True, pts, ts), _torch_slam(tp, False, pts, ts)


def _assert_close_poses(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        dt, dr = pose_errors(a, b)
        assert dt <= TRANS_TOL_M and dr <= ROT_TOL_RAD, (dt, dr)


def test_lidar_odometry_matches_jax(scans, replays):
    """The odometry chain (float64 host poses) of both wrappers."""
    jslam, pipe, _ = replays
    assert isinstance(pipe.odometry, LidarOdometry)
    assert isinstance(jslam.odometry, JaxOdometry)
    assert len(pipe.odometry.odom_buffer) == len(scans[0])
    _assert_close_poses(pipe.odometry.odom_buffer._transforms,
                        jslam.odometry.odom_buffer._transforms)
    assert pipe.odometry.n_failed == jslam.odometry.n_failed == 0


def test_slam_wrapper_replay_matches_jax(scans, replays):
    _, ts, gt = scans
    jslam, pipe, _ = replays
    t_j, p_j = jslam.get_trajectory()
    t_p, p_p = pipe.get_trajectory()
    assert t_p == t_j == ts
    _assert_close_poses(p_p, p_j)
    h_j, h_p = jslam.get_health(), pipe.get_health()
    for k in ("n_submaps", "n_odometry_failures", "n_refinement_skips",
              "n_merge_skips_min_movement"):
        assert h_p[k] == h_j[k], k
    assert h_p["n_submaps"] >= 3        # switched at least once, then closed
    # Map sizes agree up to the points moved by sub-millimetre pose gaps.
    assert abs(h_p["n_map_points"] - h_j["n_map_points"]) <= 0.01 * h_j["n_map_points"]
    # And the replay tracks the simulator's ground truth.
    for T_gt, T in zip(gt, p_p):
        dt, _ = pose_errors(np.linalg.inv(gt[0]) @ T_gt, T)
        assert dt < 0.05


def test_pipelined_replay_matches_sequential(replays):
    """Both modes run the same programs in the same order: identical poses,
    health counters, and nothing left in flight."""
    _, pipe, seq = replays
    t_p, p_p = pipe.get_trajectory()
    t_s, p_s = seq.get_trajectory()
    assert t_p == t_s
    for a, b in zip(p_p, p_s):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pipe.odometry.odom_to_range_sensor_cumulative,
                                  seq.odometry.odom_to_range_sensor_cumulative)
    assert pipe.get_health() == seq.get_health()
    assert pipe._map_pending is None and not pipe.odometry._pending


def test_interop_round_trips(rng):
    pts = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    j = jpc.from_numpy(pts, normals=pts * 0.1, colors=np.abs(pts) * 0.1, capacity=128)
    arrays = {k: np.asarray(getattr(j, k)) for k in ("points", "mask", "normals", "colors")}
    t = interop.cloud_from_arrays(**arrays)
    assert t.capacity == 128 and t.device.type == "cpu"
    back = interop.cloud_to_arrays(t)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    jp = small_jax_params()
    tp = to_torch_params(jp)
    assert interop.params_to_dict(tp) == dataclasses.asdict(jp)
    with pytest.raises(tcfg.ConfigError):
        interop.params_from_dict({"mapper": {"no_such_field": 1}})


@pytest.mark.parametrize("flag", ["is_attempt_loop_closures", "is_build_dense_map",
                                  "is_undistort_input_cloud"])
def test_wrapper_refuses_later_slices(flag, scans):
    """The flags the first slice refused are all ported now and accepted:
    loop closures, undistortion, and the dense map (which runs a scan here,
    into the active submap's dense store).  Along the closure path so is the
    ICP refinement of odometry constraints (point-to-plane ICP, kernel K4;
    it runs in
    ``test_torch_pose_graph.py::test_refined_odometry_constraints_are_refused``)."""
    tp = to_torch_params(small_jax_params())
    owner = tp.motion_compensation if flag == "is_undistort_input_cloud" else tp.mapper
    setattr(owner, flag, True)
    if flag == "is_build_dense_map":
        tp.capacities.raw_scan = 8192
        tp.capacities.dense_submap_voxels = 16384
        slam = SlamWrapper(tp, device="cpu")
        assert slam.process_scan(scans[0][0], scans[1][0])
        assert int(slam.submaps.get_active_submap().dense_map.num_voxels()) > 0
        return
    assert getattr(owner, flag) and SlamWrapper(tp, device="cpu").params is tp
    if flag == "is_attempt_loop_closures":
        tp.mapper.is_refine_odometry_constraints_between_submaps = True
        slam = SlamWrapper(tp, device="cpu")
        assert slam.params.mapper.is_refine_odometry_constraints_between_submaps


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        SlamWrapper(to_torch_params(small_jax_params()))
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_packaged_configs_turn_loop_closures_off():
    """The port no longer ships configs of its own that turn loop closures
    off: ``config_path`` finds the repo's ``configs/``, whose VLP-16 and
    default configurations turn them on, at the capacities of the first
    slice.  A caller that wants them off sets the flag, as the replays of
    this file do."""
    path = tcfg.config_path("velodyne_puck16.yaml")
    assert pathlib.Path(path).parent.name == "configs"
    assert pathlib.Path(path).parent.parent.name != "open3d_slam_torch"
    p = tcfg.load_parameters_from_file(path)
    assert p.mapper.is_attempt_loop_closures
    assert not p.motion_compensation.is_undistort_input_cloud
    assert (p.capacities.raw_scan, p.capacities.processed_scan,
            p.capacities.map_patch, p.capacities.submap_points) == (32768, 16384, 65536, 163840)
    assert p.odometry.scan_processing.down_sampling_ratio == 1.0
    assert tcfg.load_parameters_from_file(
        tcfg.config_path("default.yaml")).mapper.is_attempt_loop_closures
    p.mapper.is_attempt_loop_closures = False
    assert not SlamWrapper(p, device="cpu").params.mapper.is_attempt_loop_closures


def test_mapping_cli_on_cpu(tmp_path, capsys):
    """``--synthetic`` replay through the CLI at small capacities on the CPU,
    with an evaluation JSON.  The synthetic world is sparse, so the
    refinement gate is lowered: the test is of the plumbing, not of
    accuracy."""
    param = tmp_path / "small.yaml"
    param.write_text(
        "include: {}\n"
        "capacities: {{raw_scan: 32768, processed_scan: 1024, map_patch: 2048, "
        "submap_points: 8192}}\n"
        "odometry: {{scan_processing: {{voxel_size: 0.6}}, scan_matcher: {{icp: "
        "{{max_num_iter: 8, knn: 8, max_distance_knn: 1.5}}}}}}\n"
        "mapper: {{is_print_timing_statistics: false, scan_processing: "
        "{{voxel_size: 0.6}}, map_builder: {{map_voxel_size: 0.6}}, scan_matcher: "
        "{{min_refinement_fitness: 0.1, icp: {{max_num_iter: 8, knn: 8, "
        "max_distance_knn: 1.5}}}}}}\n".format(
            tcfg.config_path("default.yaml")))
    out = tmp_path / "eval.json"
    rc = tcli.main(["--synthetic", "9", "--device", "cpu", "--param", str(param),
                    "--eval-json", str(out)])
    assert rc == 0
    metrics = json.loads(out.read_text())
    assert metrics["device"] == "cpu" and metrics["n_poses"] == 4
    assert np.isfinite(metrics["ate_rmse_m"])
    assert tcli.main(["--sim", "list"]) == 0
    assert "vlp16_yard_circle" in capsys.readouterr().out


def test_port_imports_nothing_of_jax():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "open3d_slam_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "open3d_slam_tpu"), (path, name)
