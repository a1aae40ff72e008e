"""Port vs JAX over the localization slice: the pose hypotheses, multi-start
global localization, the localization CLI with ``SlamMapInitializer``'s gate
window, short replays with point-to-plane and point-to-point ICP, and the
ICP refinement of odometry constraints.

The JAX package runs on its kernel path (``torch_parity.jax_kernel_path``,
Pallas in interpret mode, K4 included) and hands its random draws to the
port.  Tolerances: global localization's final pose within 2 mm and 2 mrad
of JAX's (measured 2e-4; the funnel runs five stages of float32 Gauss-Newton
steps from Grams summed in other orders) and the same winner; the replays,
handed the JAX package's preprocessed clouds, 3 mm and 2 mrad per pose (as
``test_torch_slice.py``); the CLI's printed poses to their printed 0.01 m; a
refined constraint 1e-4.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from open3d_slam_tpu.cli import localization as jcli
from open3d_slam_tpu.io import datasets as jdatasets, lidar_sim
from open3d_slam_tpu.models import constraints as jcons
from open3d_slam_tpu.models.map_initializer import SlamMapInitializer as JaxInitializer
from open3d_slam_tpu.models.slam_wrapper import SlamWrapper as JaxSlamWrapper
from open3d_slam_tpu.ops import registration as jreg
from open3d_slam_tpu.parallel import multi_start as jms
from open3d_slam_tpu.utils import config as jcfg, pointcloud as jpc
from open3d_slam_torch.cli import localization as tcli, mapping as tmapping
from open3d_slam_torch.io import datasets as tdatasets, pcd
from open3d_slam_torch.models import constraints as tcons
from open3d_slam_torch.models.map_initializer import SlamMapInitializer
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.ops import registration as treg
from open3d_slam_torch.parallel import multi_start as tms
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import jax_kernel_path, pose_errors, small_jax_params, to_torch_params

TRANS_TOL_M, ROT_TOL_RAD = 3e-3, 2e-3


@pytest.mark.parametrize("n", [8, 32, 100])
def test_make_pose_hypotheses_matches_jax(rng, n):
    pts = rng.uniform(-7, 9, (300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.2
    want = jms.make_pose_hypotheses(pts, mask, n, z=1.5)
    got = tms.make_pose_hypotheses(pts, mask, n, z=1.5)
    assert got.shape == (n, 4, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _jax_scores(key: int, n: int) -> torch.Tensor:
    """The draws of the JAX package's ``random_downsample`` under
    ``PRNGKey(key)``."""
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(key), (n,))))


class _FinalInit:
    """Records the init of the funnel's last stage (the winner's refined
    pose) in a registration module, then calls through."""

    def __init__(self, monkeypatch, module):
        self.fn, self.init = module.icp_point_to_plane, None
        monkeypatch.setattr(module, "icp_point_to_plane", self)

    def __call__(self, source, grid, init, *args, **kwargs):
        self.init = np.array(init)
        return self.fn(source, grid, init, *args, **kwargs)


def test_global_localize_matches_jax(monkeypatch):
    """32 hypotheses on a 2048-point structured scene (extent 6 m) and a
    512-point planted scan, the JAX package's draws for keys 11/12/13."""
    map_pts = tdatasets.structured_scene(np.random.default_rng(4), 2048, extent=6.0)
    scan, T_true = tdatasets.planted_scan(map_pts, np.random.default_rng(101), 512)
    jp = jcfg.SlamParameters()
    jp.mapper.scan_matcher.icp.max_correspondence_distance = 1.0
    jp.mapper.scan_processing.voxel_size = 0.3
    j_final, t_final = _FinalInit(monkeypatch, jreg), _FinalInit(monkeypatch, treg)
    stages = {}
    T_t, fit_t = tms.global_localize(
        tpc.from_numpy(scan, capacity=512), tpc.from_numpy(map_pts, capacity=2048),
        to_torch_params(jp), num_hypotheses=32, draw_scores=_jax_scores, profile=stages)
    with jax_kernel_path():
        T_j, fit_j = jms.global_localize(jpc.from_numpy(scan, capacity=512),
                                         jpc.from_numpy(map_pts, capacity=2048), jp,
                                         num_hypotheses=32)
    assert set(stages) == set(tms.STAGES)
    dt, dr = pose_errors(t_final.init, j_final.init)          # the same winner
    assert dt < 1e-2 and dr < 1e-2, (dt, dr)
    dt, dr = pose_errors(T_t, np.asarray(T_j, np.float64))
    assert dt <= 2e-3 and dr <= 2e-3, (dt, dr)
    assert abs(fit_t - fit_j) <= 2e-3 and fit_t > 0.9
    assert pose_errors(T_t, T_true)[0] < 0.05


def test_global_localize_default_draws_are_seeded():
    map_pts = tdatasets.structured_scene(np.random.default_rng(2), 2048, extent=6.0)
    scan, _ = tdatasets.planted_scan(map_pts, np.random.default_rng(7), 512)
    a, b = tms.SeededScores("cpu")(11, 64), tms.SeededScores("cpu")(11, 64)
    assert torch.equal(a, b) and not torch.equal(a, tms.SeededScores("cpu")(12, 64))
    p = to_torch_params(jcfg.SlamParameters())
    runs = [tms.global_localize(tpc.from_numpy(scan, capacity=512),
                                tpc.from_numpy(map_pts, capacity=2048), p,
                                num_hypotheses=8) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])


# --- the localization CLI ----------------------------------------------------

_PARAMS = """
capacities:
  raw_scan: 4096
  processed_scan: 2048
  submap_points: 8192
  map_patch: 4096
  feature_cloud: 1024
odometry:
  scan_processing: {voxel_size: 0.4, down_sampling_ratio: 1.0}
  scan_matcher:
    icp: {max_correspondence_distance: 1.0, max_num_iter: 12, knn: 10, max_distance_knn: 1.2}
mapper:
  scan_processing: {voxel_size: 0.4, down_sampling_ratio: 1.0}
  scan_matcher:
    icp: {max_correspondence_distance: 1.0, max_num_iter: 12, knn: 10, max_distance_knn: 1.2}
  map_builder: {map_voxel_size: 0.4}
  is_build_dense_map: false
  is_attempt_loop_closures: false
"""


def _small_sequence(n_scans):
    return jdatasets.make_synthetic_sequence(
        n_scans=n_scans, trajectory="straight", step=0.4, n_points=2000, max_range=22.0,
        world_cfg=jdatasets.SyntheticWorldConfig(extent=22.0, n_ground=30000,
                                                 n_walls=20000, n_pillars=10000))


def _pose_lines(out):
    rows = [line.split("xyz=(")[1].rstrip(")").split(",") for line in out.splitlines()
            if "pose xyz=(" in line]
    return np.asarray(rows, np.float64)


def test_localization_cli_matches_jax(tmp_path, capsys):
    """Map a synthetic sequence with the port's mapping CLI, then localize
    its scans in the saved map with both CLIs from the same initial pose,
    the first two scans as the interactive window.  The map's capacity is
    small: the JAX package estimates its normals in Pallas interpret mode."""
    seq_dir, param = tmp_path / "seq", tmp_path / "small.yaml"
    jdatasets.save_sequence(_small_sequence(3), str(seq_dir))
    param.write_text(_PARAMS)
    assert tmapping.main(["--sequence", str(seq_dir), "--param", str(param),
                          "--save-folder", str(tmp_path / "m"), "--save-map",
                          "--no-skip-first", "--device", "cpu"]) == 0
    capsys.readouterr()
    argv = ["--map", str(tmp_path / "m" / "map.pcd"), "--sequence", str(seq_dir),
            "--param", str(param), "--initial-pose", "0", "0", "1.5", "0", "0", "0.01",
            "--interactive-init-scans", "2"]
    assert tcli.main(argv + ["--device", "cpu", "--save-poses",
                             str(tmp_path / "poses.npz")]) == 0
    out_t = capsys.readouterr().out
    with jax_kernel_path():
        assert jcli.main(argv) == 0
    out_j = capsys.readouterr().out
    for out in (out_t, out_j):
        assert "loaded map" in out and out.count("Finished setting initial map!") == 1
    got, want = _pose_lines(out_t), _pose_lines(out_j)
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, atol=0.01 + 1e-9)
    saved = np.load(tmp_path / "poses.npz")
    np.testing.assert_allclose(saved["poses"][:, :3, 3], got, atol=0.005 + 1e-9)
    np.testing.assert_allclose(saved["poses"][0][:3, 3], [0, 0, 1.5], atol=1e-9)


_GLOBAL_PARAMS = """
capacities: {raw_scan: 1024, processed_scan: 1024, submap_points: 4096, map_patch: 4096}
mapper:
  scan_processing: {voxel_size: 0.3}
  scan_matcher:
    icp: {max_correspondence_distance: 1.0}
  is_build_dense_map: false
"""


def test_localization_cli_global_init_on_cpu(tmp_path, capsys):
    """``--global-init``: no initial pose; the first scan is localized by
    the multi-start funnel in the loaded map, then tracked from there."""
    map_pts = tdatasets.structured_scene(np.random.default_rng(4), 4096, extent=8.0)
    scan, T_true = tdatasets.planted_scan(map_pts, np.random.default_rng(101), 1024)
    pcd.write_pcd(str(tmp_path / "map.pcd"), points=map_pts)
    tdatasets.save_sequence(tdatasets.SyntheticSequence(
        scans=[scan], timestamps=[0.0], ground_truth=[T_true]), str(tmp_path / "seq"))
    (tmp_path / "p.yaml").write_text(_GLOBAL_PARAMS)
    assert tcli.main(["--map", str(tmp_path / "map.pcd"), "--sequence",
                      str(tmp_path / "seq"), "--param", str(tmp_path / "p.yaml"),
                      "--global-init", "--num-hypotheses", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "global init: fitness" in out and "over 32 hypotheses" in out
    np.testing.assert_allclose(_pose_lines(out)[0], T_true[:3, 3], atol=0.05)


def test_map_initializer_gate_window_matches_jax():
    """SlamMapInitializer's gate semantics (SlamMapInitializer.cpp:79-93)
    on both packages' classes: merging off and the fitness gate ignored in
    the window; merging back at once, the gate one scan later."""
    states = []
    for cls in (SlamMapInitializer, JaxInitializer):
        slam = types.SimpleNamespace(params=jcfg.SlamParameters(), calls=[])
        slam.params.mapper.is_merge_scans_into_map = True
        slam.set_initial_map = lambda pts, s=slam: s.calls.append(("map", pts.shape))
        slam.set_initial_transform = lambda T, s=slam: s.calls.append(("T", T.shape))
        ini = cls(slam)
        mp = slam.params.mapper
        ini.initialize(np.zeros((10, 3), np.float32), np.eye(4))
        seen = [(mp.is_merge_scans_into_map, mp.is_ignore_min_refinement_fitness)]
        ini.begin_interactive_init()
        seen.append((mp.is_merge_scans_into_map, mp.is_ignore_min_refinement_fitness))
        ini.update_pose(np.eye(4))
        ini.finish_initialization()
        seen.append((mp.is_merge_scans_into_map, mp.is_ignore_min_refinement_fitness))
        ini.notify_scan_processed()
        seen.append((mp.is_merge_scans_into_map, mp.is_ignore_min_refinement_fitness))
        states.append((seen, slam.calls))
    assert states[0] == states[1]
    assert states[0][0] == [(True, False), (False, True), (True, True), (True, False)]


# --- replays with the other registration types --------------------------------

@pytest.fixture(scope="module")
def yard_scans():
    """The first scans of the simulated VLP-16 yard circle, every 4th return
    (the scans of tests/test_torch_slice.py)."""
    spec = dataclasses.replace(lidar_sim.BENCHMARK_SEQUENCES["vlp16_yard_circle"],
                               n_scans=6)
    seq = lidar_sim.make_sim_sequence(spec, cache_dir="")
    return [s[::4] for s in seq.scans], list(seq.timestamps), seq.ground_truth


class _HandedOver:
    """Each cloud a JAX owner's ``preprocess`` returns, handed in turn to
    the port's owner as its own ``preprocess`` result.

    The port's voxel means differ from the JAX package's by ~2e-6 m (int64
    fixed point against a float32 running sum, ROADMAP.md §3), which moves
    the k-th neighbour, and so the normal, of a few points of a scan (6 of
    1024 turned by over 8 degrees on the yard's second scan).
    Point-to-plane ICP reads each normal, and its fitness-delta stop then
    fires at another iteration: 0.8 mm and 0.6 mrad apart after one scan,
    2.6 cm after five.  The preprocessing is held against JAX in
    tests/test_torch_slice.py, test_torch_voxel.py and test_torch_normals.py;
    here both wrappers register, gate and merge the same clouds."""

    def __init__(self, jowner, towner):
        self.clouds, self.jax_preprocess = [], jowner.preprocess
        jowner.preprocess = self.record
        towner.preprocess = self.hand_over

    def record(self, cloud):
        out = self.jax_preprocess(cloud)
        self.clouds.append(out)
        return out

    def hand_over(self, cloud):
        c = self.clouds.pop(0)
        return tpc.PointCloud(points=torch.from_numpy(np.array(c.points)),
                              mask=torch.from_numpy(np.array(c.mask)),
                              normals=None if c.normals is None else
                              torch.from_numpy(np.array(c.normals)))


@pytest.mark.parametrize("reg_type", ["PointToPlaneIcp", "PointToPointIcp"])
def test_replay_with_other_registration_types_matches_jax(yard_scans, reg_type):
    """Six yard scans through both wrappers in step, ``reg_type`` for both
    registrations (the parameters of tests/test_torch_slice.py, whose
    submaps switch), the port handed the JAX package's preprocessed clouds
    (``_HandedOver``)."""
    pts, ts, _ = yard_scans
    jp = slice_params()
    jp.odometry.scan_matcher.reg_type = reg_type
    jp.mapper.scan_matcher.scan_to_map_reg_type = reg_type
    with jax_kernel_path():
        jslam = JaxSlamWrapper(jp)
        tslam = SlamWrapper(to_torch_params(jp), device="cpu")
        assert tslam.odometry.registration.needs_normals() == (reg_type == "PointToPlaneIcp")
        for jowner, towner in ((jslam.odometry, tslam.odometry),
                               (jslam.mapper.scan_to_map_reg, tslam.mapper.scan_to_map_reg)):
            _HandedOver(jowner, towner)
        for s, t in zip(pts, ts):
            assert jslam.process_scan(s, t)
            assert tslam.process_scan(s, t)
    _, p_j = jslam.get_trajectory()
    _, p_t = tslam.get_trajectory()
    assert len(p_t) == len(p_j) == 6
    for a, b in zip(p_t, p_j):
        dt, dr = pose_errors(a, b)
        assert dt <= TRANS_TOL_M and dr <= ROT_TOL_RAD, (dt, dr)
    h_j, h_t = jslam.get_health(), tslam.get_health()
    assert h_t.pop("n_map_points") == pytest.approx(h_j.pop("n_map_points"), rel=0.01)
    assert h_t == h_j


def slice_params():
    """The parameters of tests/test_torch_slice.py: small capacities, a
    downsample ratio of 0.5, submaps small enough to switch in six scans."""
    p = small_jax_params(ratio=0.5)
    p.capacities.raw_scan = 8192
    for o in (p.odometry, p.mapper):
        o.scan_processing.voxel_size = 0.3
        o.scan_matcher.icp.max_num_iter = 30
    p.mapper.submaps.radius = 1.0
    p.mapper.submaps.min_num_range_data = 2
    p.mapper.submaps.num_scans_overlap = 2
    p.mapper.map_builder.carving.carve_space_every_n_scans = 3
    return p


# --- the ICP refinement of odometry constraints -------------------------------

def test_constraint_outputs_with_refinement_matches_jax(rng):
    """Two overlapping clouds with normals, the second shifted 6 cm and
    turned 0.01 rad: the refinement recovers the offset, and (T, info)
    match JAX's ``_build_constraint_fn(..., is_skip_icp_refinement=False)``."""
    n = 4096
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[:, 2] = np.where(rng.uniform(size=n) < 0.5, 0.0, pts[:, 2] * 0.3 + 2.0)
    pts[n // 2:, 0] = np.where(rng.uniform(size=n - n // 2) < 0.5, 5.0, pts[n // 2:, 0])
    nrm = np.zeros_like(pts)
    nrm[:, 2] = 1.0
    c, s = np.cos(0.01), np.sin(0.01)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    b = (pts @ R.T + np.float32([0.06, -0.04, 0.02])).astype(np.float32)
    args = (True, 0.6, 8.0, True, False, n, n)
    with jax_kernel_path():
        jsrc = jpc.from_numpy(pts, capacity=n, normals=nrm)
        jtgt = jpc.from_numpy(b, capacity=n, normals=nrm @ R.T)
        T_j, info_j = (np.asarray(a) for a in jcons._build_constraint_fn(*args)(jsrc, jtgt))
    T_t, info_t = tcons.constraint_outputs(
        tpc.from_numpy(pts, capacity=n, normals=nrm),
        tpc.from_numpy(b, capacity=n, normals=nrm @ R.T), *args)
    assert np.abs(T_j[:3, 3]).max() > 0.01               # the refinement moved it
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-4)
    np.testing.assert_allclose(info_t.numpy(), info_j, rtol=1e-4,
                               atol=1e-4 * np.abs(info_j).max())
