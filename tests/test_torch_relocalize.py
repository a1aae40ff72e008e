"""Relocalization, the port's entry point for a robot with no initial pose:
``SlamMapInitializer.relocalize`` on a raw scan above
``capacities.processed_scan`` points and a loaded map above
``capacities.submap_points`` points (both held whole; the CLI's
``--global-init`` on such inputs is a case of
``test_torch_localization.py::test_localization_cli_global_init_on_cpu``), the funnel held
against the benchmark's plain reference (``perfbench/reference/relocalize.py``,
float64, brute-force nearest neighbours), and the spans and counters of one
relocalization.

Against a loaded map, the funnel's map-side products are built at the
first query and kept (``SlamMapInitializer``): each query's answer and every
output it keeps must be bit-equal to ``multi_start.global_localize`` on the
same map and scan, the kept products must never be written, and a new map or
a changed setting must rebuild them.

Tolerances against the reference: the rank scores at the port's coarse poses
within 2 inliers' flip of the rank scan (an inlier within float32 rounding of
the correspondence distance may flip; measured 5e-8), and the whole funnel's
final pose within 3 mm and 0.05 degrees of the reference's funnel run from
the same hypotheses and subsamples (measured 0.8 mm and 0.005 degrees: five
stages of float32 steps, on map normals from the scene's 5 nearest
neighbours, which the two estimate apart), its fitness within 2 inliers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from open3d_slam_torch.io import datasets
from open3d_slam_torch.models.map_initializer import SlamMapInitializer
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.parallel import multi_start
from open3d_slam_torch.utils import config as cfg, pointcloud as pclib
from open3d_slam_torch.utils.timeutil import telemetry
from perfbench.reference import relocalize as ref

SCAN_POINTS, MAP_POINTS = 640, 1280
CAPACITIES = {"raw_scan": 1024, "processed_scan": 512, "submap_points": 1024,
              "map_patch": 1024, "localization_hypotheses": 32}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _params(**capacities):
    return cfg.load_parameters({
        "capacities": dict(CAPACITIES, **capacities),
        "mapper": {"scan_processing": {"voxel_size": 0.3},
                   "scan_matcher": {"icp": {"max_correspondence_distance": 1.0}},
                   "map_builder": {"map_voxel_size": 0.01},
                   "is_use_initial_map": True, "is_merge_scans_into_map": False,
                   "is_attempt_loop_closures": False, "is_build_dense_map": False}})


def _site(seed=101):
    map_pts = datasets.structured_scene(np.random.default_rng(4), MAP_POINTS, extent=8.0)
    scan, T_true = datasets.planted_scan(map_pts, np.random.default_rng(seed), SCAN_POINTS)
    return map_pts, scan, T_true


def _gap(a, b):
    return ref.pose_gap(torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b)))


def _valid(cloud):
    return cloud.points[cloud.mask]


def test_global_localize_against_the_reference():
    """64 hypotheses, a 2048-point map and a 512-point scan: the port's rank
    scores at its coarse poses and its final pose against the reference's."""
    map_pts = datasets.structured_scene(np.random.default_rng(4), 2048, extent=6.0)
    scan, T_true = datasets.planted_scan(map_pts, np.random.default_rng(101), 512)
    p = _params()
    icp = p.mapper.scan_matcher.icp
    keep = {}
    T, fitness = multi_start.global_localize(
        pclib.from_numpy(scan, capacity=512), pclib.from_numpy(map_pts, capacity=2048), p,
        num_hypotheses=64, keep=keep)
    world = ref.Map(map_pts, icp.knn, icp.max_distance_knn)
    rank = _valid(keep["scan_rank"])
    score = ref.rank_scores(world, rank, keep["coarse_T"], keep["max_corr"])
    assert float((score - keep["rank_score"].double()).abs().max()) <= 2.0 / len(rank)
    scans = {k: _valid(keep["scan_" + k]) for k in ("small", "mid", "rank", "full")}
    want = ref.funnel(torch.as_tensor(map_pts), scans, keep["hypotheses"], keep["coarse_corr"],
                      keep["mid_corr"], keep["max_corr"], icp.knn, icp.max_distance_knn)
    dt, dr = _gap(T, want["final_T"])
    assert dt <= 3e-3 and dr <= 0.05, (dt, dr)
    assert abs(fitness - float(want["final_fitness"])) <= 2.0 / len(scans["full"])
    assert _gap(T, T_true)[0] < 0.05


@pytest.fixture(scope="module")
def relocalized():
    """One relocalization through ``SlamMapInitializer``, its spans and
    counters recorded: (wrapper, initializer, planted pose, pose, fitness,
    recording)."""
    map_pts, scan, T_true = _site()
    p = _params()
    assert len(scan) > p.capacities.processed_scan and MAP_POINTS > p.capacities.submap_points
    slam = SlamWrapper(p, device="cpu")
    init = SlamMapInitializer(slam)
    init.initialize(map_pts)
    telemetry.start_recording()
    try:
        T, fitness = init.relocalize(np.concatenate([scan, np.full((3, 3), np.nan,
                                                                   np.float32)]))
    finally:
        rec = telemetry.stop_recording()
    return slam, init, T_true, T, fitness, rec


def test_relocalize_holds_a_raw_scan_and_a_whole_map(relocalized):
    """A scan above ``processed_scan`` points (and non-finite rows) and a map
    above ``submap_points`` points: the query is built at ``raw_scan``, the
    map and its submap grow to hold every point, and the pose found is set
    as the initial transform."""
    slam, _, T_true, T, fitness, _ = relocalized
    held = slam.mapper.submaps.get_active_submap().map_cloud
    assert int(held.mask.sum()) == MAP_POINTS and held.capacity >= MAP_POINTS
    assert _gap(T, T_true)[0] < 0.05 and fitness > 0.9
    np.testing.assert_array_equal(slam.mapper.map_to_range_sensor, T)


def test_the_mid_stage_runs_on_every_voxel_of_a_map_held_at_its_own_size():
    """A sparse map held at a capacity of its own size, whose mid-map voxels
    are more than half its points (more than the JAX package's half-capacity
    mid map holds): the port's mid stage, from its own best coarse poses,
    against the reference's on every voxel of the map."""
    map_pts = datasets.structured_scene(np.random.default_rng(7), 2600, extent=20.0)
    scan, _ = datasets.planted_scan(map_pts, np.random.default_rng(102), SCAN_POINTS)
    slam = SlamWrapper(_params(), device="cpu")
    init = SlamMapInitializer(slam)
    init.initialize(map_pts)
    keep = {}
    init.relocalize(scan, keep=keep)
    held = slam.mapper.submaps.get_active_submap().map_cloud
    mid_map = ref.voxel_centroids(torch.as_tensor(map_pts), max(0.4, keep["mid_corr"] / 5.0))
    assert len(mid_map) > held.capacity // 2
    mid = ref.point_to_point(ref.Map(mid_map), _valid(keep["scan_mid"]),
                             keep["coarse_T"][keep["best_idx"]], keep["mid_corr"], 12)
    gaps = torch.linalg.norm(mid["T"][:, :3, 3] - keep["mid_T"][:, :3, 3].double(), dim=1)
    assert float(gaps.median()) <= 1e-4, sorted(gaps.tolist())


def test_relocalize_needs_a_loaded_map():
    init = SlamMapInitializer(SlamWrapper(_params(), device="cpu"))
    with pytest.raises(RuntimeError, match="loaded map"):
        init.relocalize(_site()[1])


def test_a_relocalization_is_one_span_tree(relocalized):
    """``relocalize.query`` holds the six stages in order, the GN loops sit
    inside their stages, the hypotheses are counted, and the map's pull is
    made in the prep stage."""
    spans, counters = relocalized[-1].spans, relocalized[-1].counters
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["relocalize.query"]
    stages = [s.name for s in spans if s.parent == roots[0] and s.name != "pull"]
    assert stages == ["relocalize." + k for k in multi_start.STAGES]
    for loop, stage in (("gn_loop.p2p", "relocalize.mid"), ("gn_loop.p2l", "relocalize.coarse"),
                        ("gn_loop.p2l", "relocalize.final")):
        assert stage in {spans[s.parent].name for s in spans if s.name == loop}
    assert counters[("relocalize.prep", "relocalize.hypotheses")] == 32
    assert counters[("relocalize.prep", "pulls")] >= 1
    assert counters[("relocalize.query", "pulls")] == 1      # the pose and fitness


# --- the map's products, kept per loaded map ---------------------------------

def _leaves(x, path=""):
    """(path, value) of every tensor and plain value in ``x``: a tensor, a
    dataclass (a cloud, a grid, the map's products), a tuple or named tuple
    (K4's target, a layout and its bound version counters), a dict (what a
    query keeps) or a plain value."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}[{k}]")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def _snapshot(x) -> list:
    return [(k, v.clone() if isinstance(v, torch.Tensor) else v) for k, v in _leaves(x)]


def _assert_bit_equal(a, b):
    _assert_same_leaves(list(_leaves(a)), list(_leaves(b)))


def _assert_same_leaves(la, lb):
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, u), (_, v) in zip(la, lb):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v), k
        else:
            assert u == v, k


def _loaded(map_pts):
    slam = SlamWrapper(_params(), device="cpu")
    init = SlamMapInitializer(slam)
    init.initialize(map_pts)
    return slam, init


def _fresh(slam, scan, num_hypotheses):
    """``global_localize`` of ``scan`` as ``relocalize`` builds it, on the
    active submap's map: (T, fitness, keep)."""
    keep = {}
    T, fitness = multi_start.global_localize(
        pclib.from_numpy(scan, capacity=slam.params.capacities.raw_scan),
        slam.mapper.submaps.get_active_submap().map_cloud, slam.params,
        num_hypotheses=num_hypotheses, keep=keep)
    return T, fitness, keep


def _prep_counts(recording) -> tuple:
    """(builds, hits) of the map's products, each counted in the prep stage."""
    c = recording.counters
    assert {name for _, name in c if name.startswith("relocalize.map_prep")} <= {
        name for span, name in c if span == "relocalize.prep"}
    return (c.get(("relocalize.prep", "relocalize.map_prep_builds"), 0),
            c.get(("relocalize.prep", "relocalize.map_prep_hits"), 0))


@pytest.fixture(scope="module")
def three_queries():
    """Three scans relocalized in one loaded map, spans and counters
    recorded: (wrapper, initializer, [(scan, T, fitness, keep)], the
    products after the first query and a copy of them then, recording)."""
    map_pts = _site()[0]
    slam, init = _loaded(map_pts)
    queries = []
    telemetry.start_recording()
    try:
        for seed in (101, 102, 103):
            scan = datasets.planted_scan(map_pts, np.random.default_rng(seed), SCAN_POINTS)[0]
            keep = {}
            T, fitness = init.relocalize(scan, keep=keep)
            queries.append((scan, T, fitness, keep))
            if seed == 101:
                first = init._prepared[2]
                copy = _snapshot(first)
    finally:
        rec = telemetry.stop_recording()
    return slam, init, queries, first, copy, rec


def test_relocalize_in_a_loaded_map_is_bit_equal_to_global_localize(three_queries):
    """Each query's pose, fitness and every output it keeps against a fresh
    ``global_localize`` on the same map and scan; the kept products are the
    first query's, unwritten by the three, and equal to a fresh build."""
    slam, init, queries, first, copy, _ = three_queries
    for scan, T, fitness, keep in queries:
        T_f, fitness_f, keep_f = _fresh(slam, scan, CAPACITIES["localization_hypotheses"])
        assert np.array_equal(T, T_f) and fitness == fitness_f
        _assert_bit_equal(keep, keep_f)
    assert init._prepared[2] is first
    _assert_same_leaves(list(_leaves(first)), copy)
    _assert_bit_equal(first, multi_start.prepare_map(
        slam.mapper.submaps.get_active_submap().map_cloud, slam.params,
        CAPACITIES["localization_hypotheses"]))


def test_three_queries_build_the_map_products_once(three_queries):
    rec = three_queries[-1]
    assert _prep_counts(rec) == (1, 2)
    assert rec.counters[("relocalize.prep", "relocalize.hypotheses")] == 3 * 32


FEW_HYPOTHESES = 8      # the rebuild cases' hypotheses, unless changed


def _initialize_again(slam, init, other):
    """A second ``initialize``: the cloud goes through the mapper as a scan
    and, with merging off (localization mode), leaves the map as it is."""
    init.initialize(other)
    return FEW_HYPOTHESES


def _replace_map(slam, init, other):
    """A new cloud in the active submap, as a load, a merge or a submap
    transform assigns one."""
    sub = slam.mapper.submaps.get_active_submap()
    sub.map_cloud = sub.map_cloud.with_(
        points=sub.map_cloud.points + torch.tensor([0.5, -0.3, 0.0]))
    return FEW_HYPOTHESES


def _more_hypotheses(slam, init, other):
    return 2 * FEW_HYPOTHESES


def _wider_correspondences(slam, init, other):
    slam.params.mapper.scan_matcher.icp.max_correspondence_distance = 1.2
    return FEW_HYPOTHESES


@pytest.mark.parametrize("change, builds", [(_initialize_again, 0), (_replace_map, 1),
                                            (_more_hypotheses, 1),
                                            (_wider_correspondences, 1)],
                         ids=["initialize_again", "map_replaced", "num_hypotheses",
                              "max_correspondence_distance"])
def test_a_new_map_or_setting_rebuilds_the_map_products(change, builds):
    """After a first query, ``change`` (which gives the second query's
    hypothesis count) then a second query: the products are
    rebuilt exactly when the map object, the hypothesis count or a setting
    they are built from changed, and the answer and everything kept are
    those of a fresh ``global_localize`` on the map now held."""
    map_pts, scan, _ = _site()
    slam, init = _loaded(map_pts)
    init.relocalize(scan, num_hypotheses=FEW_HYPOTHESES)
    other = datasets.structured_scene(np.random.default_rng(9), MAP_POINTS, extent=8.0)
    n = change(slam, init, other)
    scan = datasets.planted_scan(map_pts, np.random.default_rng(102), SCAN_POINTS)[0]
    keep = {}
    telemetry.start_recording()
    try:
        T, fitness = init.relocalize(scan, num_hypotheses=n, keep=keep)
    finally:
        rec = telemetry.stop_recording()
    assert _prep_counts(rec) == (builds, 1 - builds)
    T_f, fitness_f, keep_f = _fresh(slam, scan, n)
    assert np.array_equal(T, T_f) and fitness == fitness_f
    _assert_bit_equal(keep, keep_f)
    assert init._prepared[0] is slam.mapper.submaps.get_active_submap().map_cloud
