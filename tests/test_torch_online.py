"""Port vs JAX: the dense-map stage of ``SlamWrapper``, its accessors, the
visualization getters, the odometry and mapper accessors, the online
driver (``AsyncSlamDriver``) and the rest of the mapping CLI.

The replays are those of ``tests/test_torch_slice.py`` (the first scans of
the simulated VLP-16 yard, every 4th return, at small capacities), with the
dense map on and height-coded colours, as ``tests/test_slam_wrapper_e2e.py``
feeds them.  Poses are held to that file's tolerance (3 mm, 2 mrad).  The
dense maps of the two packages are built at those (sub-millimetre apart)
poses, so a point near a voxel face can land in the next voxel: their voxel
counts are held within 1% and their mean colours within 1e-3.

Within the port, the dense map is write-only for tracking: poses with it on
are bit-equal to poses with it off, with the same host syncs; pipelined and
sequential replays give bit-identical dense clouds; the online driver gives
the sequential poses bit for bit.
"""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from open3d_slam_tpu.cli import mapping as jcli
from open3d_slam_tpu.io import lidar_sim
from open3d_slam_tpu.models.odometry import LidarOdometry as JaxOdometry
from open3d_slam_tpu.models.slam_wrapper import SlamWrapper as JaxSlamWrapper
from open3d_slam_tpu.utils import config as jcfg, pointcloud as jpc
from open3d_slam_torch.cli import mapping as tcli
from open3d_slam_torch.io import datasets, pcd
from open3d_slam_torch.models.async_driver import AsyncSlamDriver
from open3d_slam_torch.models.odometry import LidarOdometry
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.utils import device as tdevice
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import (JaxScores, jax_kernel_path, pose_errors, small_jax_params,
                          to_torch_params)

TRANS_TOL_M = 3e-3
ROT_TOL_RAD = 2e-3
N_SCANS = 6


@pytest.fixture(scope="module")
def scans():
    spec = dataclasses.replace(lidar_sim.BENCHMARK_SEQUENCES["vlp16_yard_circle"],
                               n_scans=N_SCANS)
    seq = lidar_sim.make_sim_sequence(spec, cache_dir="")
    pts = [s[::4] for s in seq.scans]
    return pts, list(seq.timestamps), [_height_colors(s) for s in pts]


def _height_colors(scan):
    """Red = normalised height, green 0.5, blue = 1 - red
    (``tests/test_slam_wrapper_e2e.py``)."""
    z = scan[:, 2]
    r = (z - z.min()) / max(float(np.ptp(z)), 1e-6)
    return np.stack([r, 0.5 * np.ones_like(r), 1.0 - r], axis=1).astype(np.float32)


def _params(dense=True):
    """``test_torch_slice.py``'s small replay, with the dense map on: 0.25 m
    voxels cropped at 12 m, carved every third scan."""
    p = small_jax_params(ratio=0.5)
    p.capacities.raw_scan = 8192
    p.capacities.dense_submap_voxels = 16384
    for o in (p.odometry, p.mapper):
        o.scan_processing.voxel_size = 0.3
        o.scan_matcher.icp.max_num_iter = 30
    p.mapper.submaps.radius = 1.0
    p.mapper.submaps.min_num_range_data = 2
    p.mapper.submaps.num_scans_overlap = 2
    p.mapper.map_builder.carving.carve_space_every_n_scans = 3
    p.mapper.is_build_dense_map = dense
    b = p.mapper.dense_map_builder
    b.map_voxel_size = 0.25
    b.cropper.cropping_max_radius = 12.0
    b.carving.carve_space_every_n_scans = 3
    return p


def _torch_slam(params, scans, mode="pipelined"):
    pts, ts, cols = scans
    slam = SlamWrapper(params, device="cpu")
    slam.odometry.draw_scores = JaxScores(0)
    slam.mapper.scan_to_map_reg.draw_scores = JaxScores(1)
    syncs = tdevice.host_syncs.count
    step = slam.process_scan_pipelined if mode == "pipelined" else slam.process_scan
    for s, t, c in zip(pts, ts, cols):
        step(s, t, colors=c)
    slam.finish_processing()
    slam.test_host_syncs = tdevice.host_syncs.count - syncs
    return slam


@pytest.fixture(scope="module")
def replays(scans):
    """JAX (pipelined, dense on) and the port: pipelined and sequential with
    the dense map on, pipelined with it off."""
    pts, ts, cols = scans
    jp = _params()
    with jax_kernel_path():
        jslam = JaxSlamWrapper(jp)
        for s, t, c in zip(pts, ts, cols):
            jslam.process_scan_pipelined(s, t, colors=c)
        jslam.finish_processing()
    tp = to_torch_params(jp)
    return {"jax": jslam, "pipe": _torch_slam(tp, scans),
            "seq": _torch_slam(tp, scans, mode="sequential"),
            "off": _torch_slam(to_torch_params(_params(dense=False)), scans)}


def _assert_close_poses(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        dt, dr = pose_errors(a, b)
        assert dt <= TRANS_TOL_M and dr <= ROT_TOL_RAD, (dt, dr)


def test_dense_map_replay_matches_jax(replays):
    """The coloured-scan case of ``tests/test_slam_wrapper_e2e.py``: the
    colours reach the dense map's voxel means, in the port as in JAX."""
    jslam, pipe = replays["jax"], replays["pipe"]
    _assert_close_poses(pipe.get_trajectory()[1], jslam.get_trajectory()[1])
    got, want = pipe.get_dense_map_cloud(), jslam.get_dense_map_cloud()
    assert set(got) == set(want) == {"points", "normals", "colors"}
    assert got["colors"].shape == got["points"].shape
    n, n_j = got["points"].shape[0], want["points"].shape[0]
    assert n > 1000 and abs(n - n_j) <= 0.01 * n_j, (n, n_j)
    np.testing.assert_allclose(got["colors"].mean(axis=0), want["colors"].mean(axis=0),
                               atol=1e-3)
    assert abs(float(got["colors"][:, 1].mean()) - 0.5) < 1e-6
    assert float(got["colors"][:, 0].std()) > 0.05
    # The raw scans carry no normals: the dense normals are zero, as in JAX.
    assert not got["normals"].any() and not want["normals"].any()
    # Each submap's store holds the configured capacity and voxel size.
    for s, js in zip(pipe.submaps.submaps, jslam.submaps.submaps):
        assert s.dense_map.capacity == js.dense_map.capacity == 16384
        assert s.n_scans_inserted_dense == js.n_scans_inserted_dense
    assert sum(s.n_scans_inserted_dense for s in pipe.submaps.submaps) == N_SCANS


def test_dense_map_is_write_only_for_tracking(replays):
    """Poses with the dense map on are bit-equal to poses with it off, and
    the dense stage adds no host sync."""
    on, off = replays["pipe"], replays["off"]
    t_on, p_on = on.get_trajectory()
    t_off, p_off = off.get_trajectory()
    assert t_on == t_off
    for a, b in zip(p_on, p_off):
        np.testing.assert_array_equal(a, b)
    assert on.test_host_syncs == off.test_host_syncs
    assert all(s.dense_map is None for s in off.submaps.submaps)
    assert off.get_dense_map_cloud()["points"].shape == (0, 3)


def test_pipelined_and_sequential_dense_maps_identical(replays):
    pipe, seq = replays["pipe"], replays["seq"]
    for a, b in zip(pipe.get_trajectory()[1], seq.get_trajectory()[1]):
        np.testing.assert_array_equal(a, b)
    got, want = pipe.get_dense_map_cloud(), seq.get_dense_map_cloud()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dump_dense_submaps_reads_back(replays, tmp_path):
    pipe = replays["pipe"]
    pipe.dump_submaps("dense_submap", dense=True, folder=str(tmp_path))
    pipe.dump_submaps("submap", folder=str(tmp_path))
    n = pipe.submaps.get_num_submaps()
    back = [pcd.read_pcd(str(tmp_path / f"dense_submap_{i}.pcd")) for i in range(n)]
    want = pipe.get_dense_map_cloud()
    # A PCD packs colours 8 bits a channel into its rgb field.
    want["colors"] = (np.clip(want["colors"] * 255.0, 0, 255).astype(np.uint32)
                      .astype(np.float32) / 255.0)
    for k in ("points", "normals", "colors"):
        got = np.concatenate([b[k] for b in back if k in b and len(b[k])])
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    assert len(back[-1]["points"]) == 0      # the submap finish_processing opens
    for i, s in enumerate(pipe.submaps.submaps):
        sparse = pcd.read_pcd(str(tmp_path / f"submap_{i}.pcd"))
        np.testing.assert_array_equal(sparse["points"], tpc.to_numpy(s.map_cloud)["points"])


def test_visualization_getters_match_jax(replays):
    jslam, pipe = replays["jax"], replays["pipe"]
    got, want = (pipe.get_colored_submaps_for_visualization(),
                 jslam.get_colored_submaps_for_visualization())
    assert got["colors"].shape == got["points"].shape
    for c in np.unique(want["colors"], axis=0):
        n = int(np.all(got["colors"] == c, axis=1).sum())
        n_j = int(np.all(want["colors"] == c, axis=1).sum())
        assert abs(n - n_j) <= 0.01 * n_j, (c, n, n_j)
    got, want = (pipe.get_assembled_map_for_visualization(),
                 jslam.get_assembled_map_for_visualization())
    n, n_j = got["points"].shape[0], want["points"].shape[0]
    assert n > 100 and abs(n - n_j) <= 0.01 * n_j, (n, n_j)


def test_odometry_and_mapper_accessors_match_jax(scans, replays):
    jslam, pipe = replays["jax"], replays["pipe"]
    _, ts, _ = scans
    assert pipe.odometry.has_processed_measurements()
    assert pipe.mapper.has_processed_measurements()
    for t in (ts[0], 0.5 * (ts[2] + ts[3]), ts[-1], ts[-1] + 1.0):
        for got, want in (
                (pipe.odometry.get_odom_to_range_sensor(t),
                 jslam.odometry.get_odom_to_range_sensor(t)),
                (pipe.mapper.get_map_to_range_sensor(t),
                 jslam.mapper.get_map_to_range_sensor(t)),
                (pipe.mapper.get_map_to_odom(t), jslam.mapper.get_map_to_odom(t))):
            dt, dr = pose_errors(got, want)
            assert dt <= TRANS_TOL_M and dr <= ROT_TOL_RAD, (t, dt, dr)
    assert pipe.mapper.get_active_submap() is pipe.submaps.get_active_submap()
    assert pipe.mapper.get_active_submap().id == jslam.mapper.get_active_submap().id
    got = pipe.odometry.get_pre_processed_cloud()
    want = jslam.odometry.get_pre_processed_cloud()
    assert int(got.count()) == int(want.count()) > 0
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    pipe.mapper.set_map_to_range_sensor(T)
    np.testing.assert_array_equal(pipe.mapper.map_to_range_sensor, T)


def test_odometry_add_range_scan_matches_jax(scans):
    """The blocking ``LidarOdometry.add_range_scan``: fresh owners, the first
    three scans, each finalized at once."""
    pts, ts, _ = scans
    jp = _params()
    todo = LidarOdometry(to_torch_params(jp).odometry, processed_capacity=2048,
                         device="cpu")
    todo.draw_scores = JaxScores(0)
    assert not todo.has_processed_measurements() and todo.get_pre_processed_cloud() is None
    with jax_kernel_path():
        jodo = JaxOdometry(jp.odometry, processed_capacity=2048)
        for s, t in zip(pts[:3], ts[:3]):
            assert jodo.add_range_scan(jpc.from_numpy(s, capacity=8192), t)
    for s, t in zip(pts[:3], ts[:3]):
        assert todo.add_range_scan(tpc.from_numpy(s, capacity=8192), t)
    assert todo.has_processed_measurements()
    _assert_close_poses([todo.get_odom_to_range_sensor(t) for t in ts[:3]],
                        [jodo.get_odom_to_range_sensor(t) for t in ts[:3]])
    assert not todo.add_range_scan(tpc.from_numpy(pts[0], capacity=8192), ts[0] - 1.0)


@pytest.fixture(scope="module")
def async_seq():
    """The scans of ``tests/test_async_and_regtypes.py``'s async test."""
    return datasets.make_synthetic_sequence(
        n_scans=8, trajectory="straight", step=0.4, n_points=4000, max_range=22.0,
        world_cfg=datasets.SyntheticWorldConfig(
            extent=22.0, n_ground=30000, n_walls=20000, n_pillars=10000))


def _async_params():
    p = to_torch_params(small_jax_params())
    p.capacities.raw_scan = 8192
    return p


def _ate(gt, est):
    T0g, T0e = gt[0], est[0]
    return float(np.mean([np.linalg.norm((np.linalg.inv(T0g) @ g)[:3, 3] -
                                         (np.linalg.inv(T0e) @ e)[:3, 3])
                          for g, e in zip(gt, est)]))


def test_async_driver_matches_sequential(async_seq):
    """The worker runs the stages in ``process_queued``'s order: with every
    scan kept (the caller waits while a buffer is full), the poses are the
    sequential replay's bit for bit, and the ATE is that of
    ``tests/test_async_and_regtypes.py`` (< 0.1 m)."""
    slam = SlamWrapper(_async_params(), device="cpu")
    with AsyncSlamDriver(slam) as driver:
        for scan, t in zip(async_seq.scans, async_seq.timestamps):
            deadline = time.monotonic() + 120.0
            while driver.is_backpressured():
                assert time.monotonic() < deadline
                time.sleep(0.005)
            assert driver.add_range_scan(scan, t)
    assert driver._worker is None
    seq = SlamWrapper(_async_params(), device="cpu")
    for scan, t in zip(async_seq.scans, async_seq.timestamps):
        seq.process_scan(scan, t)
    seq.finish_processing()
    times, poses = slam.get_trajectory()
    assert times == seq.get_trajectory()[0] == list(async_seq.timestamps)
    for a, b in zip(poses, seq.get_trajectory()[1]):
        np.testing.assert_array_equal(a, b)
    assert _ate(async_seq.ground_truth, poses) < 0.1


def test_async_driver_raises_worker_errors(async_seq):
    """An error in the worker is raised at the next ``add_range_scan`` and
    at ``stop_workers``, never swallowed."""
    slam = SlamWrapper(_async_params(), device="cpu")
    failed = threading.Event()

    def broken_step():
        failed.set()
        raise ValueError("mapping step failed")

    slam._mapping_step = broken_step
    driver = AsyncSlamDriver(slam)
    driver.start_workers()
    assert failed.wait(timeout=60.0)
    driver._worker.join(timeout=60.0)
    assert not driver._worker.is_alive()
    with pytest.raises(RuntimeError, match="worker") as info:
        driver.add_range_scan(async_seq.scans[0], async_seq.timestamps[0])
    assert isinstance(info.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="worker"):
        driver.stop_workers()


def _small_capacities(p):
    """Small capacities for a configuration made with either package."""
    p.capacities.raw_scan = 8192
    p.capacities.processed_scan = 2048
    p.capacities.submap_points = 8192
    p.capacities.map_patch = 4096
    p.capacities.dense_submap_voxels = 16384
    p.capacities.feature_cloud = 1024
    p.mapper.is_print_timing_statistics = False
    return p


def _room_scans(rng, n_scans=2, n=4000, half=1.513):
    """A 3 x 3 x 2 m room with rough (1 cm) walls seen from its middle,
    moving 2 cm a scan, so a depth camera's 2 m crop keeps most of it."""
    faces = []
    for axis in range(3):
        for side in (-1.0, 1.0):
            f = rng.uniform(-half, half, (n // 6, 3))
            f[:, axis] = side * (half if axis < 2 else 1.013)
            faces.append(f)
    room = np.concatenate(faces) + rng.normal(scale=0.01, size=(n // 6 * 6, 3))
    return [(room - np.array([0.02 * i, 0.0, 0.0])).astype(np.float32)
            for i in range(n_scans)]


@pytest.mark.parametrize("config", ["defaults", "realsense.yaml"])
def test_dense_configurations_run_as_jax(rng, config):
    """``SlamWrapper()`` with its own parameters (dense map on) and
    ``configs/realsense.yaml`` (dense map on, 1 cm voxels) each run two
    scans on the CPU at small capacities, as the JAX package runs them: the
    same poses (to the replay tolerance) and dense voxels within 1%.  The
    realsense file keeps ``default.yaml``'s 2 m minimum radius on the map
    builder's and the dense map builder's crops and sets their maximum to
    2 m, so no point is left to match and none to merge: the refinement
    skips the second scan and the dense map stays empty, in both packages
    (ROADMAP §3)."""
    jp = _small_capacities(jcfg.SlamParameters() if config == "defaults"
                           else jcfg.load_parameters_from_file(jcfg.config_path(config)))
    tp = to_torch_params(jp)
    assert tp.mapper.is_build_dense_map
    scans = _room_scans(rng)
    colors = [np.clip(np.abs(s) / 1.5, 0, 1).astype(np.float32) for s in scans]
    with jax_kernel_path():
        jslam = JaxSlamWrapper(jp)
        for i, (scan, c) in enumerate(zip(scans, colors)):
            jslam.process_scan(scan, 0.1 * i, colors=c)
        jslam.finish_processing()
    slam = SlamWrapper(tp, device="cpu")
    slam.odometry.draw_scores = JaxScores(0)
    slam.mapper.scan_to_map_reg.draw_scores = JaxScores(1)
    for i, (scan, c) in enumerate(zip(scans, colors)):
        assert slam.process_scan(scan, 0.1 * i, colors=c)
    slam.finish_processing()
    _, poses = slam.get_trajectory()
    _assert_close_poses(poses, jslam.get_trajectory()[1])
    assert len(poses) == (2 if config == "defaults" else 1)
    assert slam.mapper.n_refinement_skips == jslam.mapper.n_refinement_skips
    got, want = slam.get_dense_map_cloud(), jslam.get_dense_map_cloud()
    n, n_j = got["points"].shape[0], want["points"].shape[0]
    if config == "defaults":
        assert n > 100 and abs(n - n_j) <= 0.01 * n_j, (n, n_j)
    else:      # the dense crop is [2 m, 2 m] too: nothing is kept
        assert n == n_j == 0
    assert slam.submaps.get_submap(0).dense_map.voxel_size == max(
        tp.mapper.dense_map_builder.map_voxel_size, 1e-3)


def _kitti_folder(tmp_path):
    """``tests/test_cli.py``'s synthetic KITTI folder."""
    seq = datasets.make_synthetic_sequence(
        n_scans=6, trajectory="straight", step=0.4, n_points=4000, max_range=22.0,
        world_cfg=datasets.SyntheticWorldConfig(
            extent=22.0, n_ground=30000, n_walls=20000, n_pillars=10000))
    folder = tmp_path / "kitti00"
    (folder / "velodyne").mkdir(parents=True)
    for i, s in enumerate(seq.scans):
        rec = np.concatenate([s, np.zeros((s.shape[0], 1), np.float32)], axis=1)
        rec.astype(np.float32).tofile(str(folder / "velodyne" / f"{i:06d}.bin"))
    (folder / "times.txt").write_text("\n".join(str(t) for t in seq.timestamps))
    (folder / "poses.txt").write_text(
        "\n".join(" ".join(str(v) for v in T[:3, :4].reshape(-1)) for T in seq.ground_truth))
    return folder


def _kitti_param_file(tmp_path):
    """``tests/test_cli.py``'s small parameters at smaller capacities, with
    the dense map on."""
    p = tmp_path / "small.yaml"
    p.write_text("""
capacities: {raw_scan: 8192, processed_scan: 2048, submap_points: 8192,
             map_patch: 4096, dense_submap_voxels: 16384, feature_cloud: 1024}
odometry:
  scan_processing: {voxel_size: 0.4}
  scan_matcher:
    icp: {max_correspondence_distance: 1.0, max_num_iter: 12, knn: 10, max_distance_knn: 1.2}
mapper:
  is_print_timing_statistics: false
  scan_processing: {voxel_size: 0.4}
  scan_matcher:
    icp: {max_correspondence_distance: 1.0, max_num_iter: 12, knn: 10, max_distance_knn: 1.2}
  map_builder: {map_voxel_size: 0.4}
  dense_map_builder: {map_voxel_size: 0.3, cropper: {cropping_max_radius: 10.0}}
  is_build_dense_map: true
  is_attempt_loop_closures: false
""")
    return str(p)


def test_mapping_cli_kitti_saves_dense_submaps(tmp_path):
    """``--kitti`` (``--num-accumulated-range-data 1``, a ``--max-wall-sec``
    it never reaches) in both CLIs, the JAX one on its CPU route as
    ``tests/test_cli.py`` runs it: the same scans replayed, the ATE within
    3 mm of the JAX CLI's (both about 1 cm).  The port's CLI also writes one sparse
    and one dense PCD per submap (``--save-submaps``,
    ``--save-dense-submaps``); the JAX CLI's writer fails on the empty
    submap that ``finish_processing`` leaves (ROADMAP §3), so it saves
    nothing here."""
    folder, param = _kitti_folder(tmp_path), _kitti_param_file(tmp_path)
    metrics = {}
    for name, main in (("torch", tcli.main), ("jax", jcli.main)):
        out = tmp_path / f"{name}.json"
        argv = ["--kitti", str(folder), "--param", param, "--eval-json", str(out),
                "--no-skip-first", "--num-accumulated-range-data", "1",
                "--max-wall-sec", "600", "--save-folder", str(tmp_path / name)]
        if name == "torch":
            assert main(argv + ["--device", "cpu", "--save-submaps",
                                "--save-dense-submaps"]) == 0
        else:
            assert main(argv) == 0
        metrics[name] = json.loads(out.read_text())
    got, want = metrics["torch"], metrics["jax"]
    assert got["sequence"] == want["sequence"] == "kitti_kitti00"
    assert got["n_scans"] == want["n_scans"] == 6 == got["n_poses"]
    assert got["n_submaps"] == want["n_submaps"]
    assert got["ate_rmse_m"] < 1.0 and abs(got["ate_rmse_m"] - want["ate_rmse_m"]) < 3e-3
    save = tmp_path / "torch"
    files = sorted(os.listdir(save))
    dense = [f for f in files if f.startswith("dense_submap_")]
    assert len(dense) == got["n_submaps"] == len([f for f in files
                                                   if f.startswith("submap_")])
    clouds = [pcd.read_pcd(str(save / f)) for f in dense]
    assert sum(len(c["points"]) for c in clouds) > 1000
    assert len(clouds[-1]["points"]) == 0        # the submap finish_processing opens


def test_mapping_cli_accumulates_and_stops_on_the_clock(tmp_path):
    """``--num-accumulated-range-data 2`` replays half as many (twice as
    large) scans; ``--max-wall-sec`` stops the replay and still finishes."""
    folder, param = _kitti_folder(tmp_path), _kitti_param_file(tmp_path)
    out = tmp_path / "eval.json"
    assert tcli.main(["--kitti", str(folder), "--param", param, "--no-skip-first",
                      "--device", "cpu", "--num-accumulated-range-data", "2",
                      "--eval-json", str(out)]) == 0
    assert json.loads(out.read_text())["n_poses"] == 3
    assert tcli.main(["--kitti", str(folder), "--param", param, "--no-skip-first",
                      "--device", "cpu", "--max-wall-sec", "1e-9",
                      "--save-folder", str(tmp_path / "none")]) == 0
