"""The program's span recorder (``utils.timeutil.telemetry``) on short CPU
replays at small capacities: spans nest, each scan has one root, the
scan ids count up, self time, the ``OFF`` state reads no clock and
allocates nothing, pulls are placed by span, the closure counters, the
online driver's worker keeps its own stack, and the mapping CLI's
Chrome-trace export."""
import json
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest

from open3d_slam_torch.cli import mapping as tcli
from open3d_slam_torch.io import datasets
from open3d_slam_torch.models.async_driver import AsyncSlamDriver
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.utils import config as tcfg, device as devmod, timeutil
from open3d_slam_torch.utils.timeutil import NULL_SPAN, Recording, Span, telemetry

N_SCANS = 8

SMALL = (
    "include: {}\n"
    "capacities: {{raw_scan: 32768, processed_scan: 1024, map_patch: 2048, "
    "submap_points: 8192, feature_cloud: 1024, max_submaps: 16, max_constraints: 32}}\n"
    "motion_compensation: {{is_undistort_input_cloud: true, "
    "num_poses_velocity_estimation: 2}}\n"
    "odometry: {{scan_processing: {{voxel_size: 0.6}}, scan_matcher: {{icp: "
    "{{max_num_iter: 8, knn: 8, max_distance_knn: 1.5}}}}}}\n"
    "mapper: {{is_print_timing_statistics: false, scan_processing: "
    "{{voxel_size: 0.6}}, map_builder: {{map_voxel_size: 0.6}}, submaps: "
    "{{radius: 3.0, min_num_range_data: 2, min_seconds_between_feature_computation: 0.0}}, "
    "scan_matcher: {{min_refinement_fitness: 0.1, icp: {{max_num_iter: 8, knn: 8, "
    "max_distance_knn: 1.5}}}}}}\n")


@pytest.fixture(autouse=True)
def restore_state():
    state, base = telemetry.state, telemetry._base
    yield
    telemetry.state, telemetry._base = state, base


@pytest.fixture(scope="module")
def param_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "small.yaml"
    path.write_text(SMALL.format(tcfg.config_path("default.yaml")))
    return str(path)


@pytest.fixture(scope="module")
def seq():
    return datasets.make_synthetic_sequence(n_scans=N_SCANS, trajectory="circle",
                                            radius=12.0, angle_total=2 * np.pi * 1.05)


@pytest.fixture(scope="module")
def recorded(param_file, seq):
    """A pipelined replay with undistortion and closures on, recorded from
    the first scan to ``finish_processing``."""
    slam = SlamWrapper(tcfg.load_parameters_from_file(param_file), device="cpu")
    state, base = telemetry.state, telemetry._base
    syncs = devmod.host_syncs.count
    t0 = time.time_ns()
    telemetry.start_recording()
    try:
        for s, t in zip(seq.scans, seq.timestamps):
            slam.process_scan_pipelined(s, t)
        slam.finish_processing()
    finally:
        rec = telemetry.stop_recording()
        telemetry.state, telemetry._base = state, base
    return rec, devmod.host_syncs.count - syncs, (t0, time.time_ns())


def test_spans_nest_inside_their_parents(recorded):
    rec, _, (t0, t1) = recorded
    assert rec.spans and all(s.thread == "MainThread" for s in rec.spans)
    for s in rec.spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert p.scan == s.scan
    names = {s.name for s in rec.spans}
    for want in ("slam_wrapper.ingest", "slam_wrapper.undistort", "odometry.scan",
                 "odometry.preprocess", "odometry.downsample", "odometry.target_prep",
                 "odometry.register", "odometry.normals.layout",
                 "odometry.normals.kth_prepass", "odometry.normals.moments",
                 "odometry.normals.finish", "mapper.normals.finish",
                 "mapper.preprocess", "mapper.normals.moments", "mapper.dispatch",
                 "mapper.patch_prepare", "mapper.target_prep", "mapper.register",
                 "mapper.query_order", "mapper.finalize", "submap.insert", "gn_loop.gicp",
                 "closure.features", "closure.odometry_constraints", "closure.advance",
                 "slam_wrapper.finish", "pull"):
        assert want in names, want
    by_name = {s.name: s for s in rec.spans}
    assert rec.spans[by_name["mapper.target_prep"].parent].name == "mapper.patch_prepare"
    assert rec.spans[by_name["gn_loop.gicp"].parent].name.endswith(".register")
    assert not any(n.startswith(("layer:", "pb.")) for n in names)


def test_each_scan_has_one_root_and_the_ids_count_up(recorded):
    rec, _, _ = recorded
    roots = [s for s in rec.spans if s.parent < 0]
    scans = [s.scan for s in roots if s.name == "slam_wrapper.scan"]
    assert scans == list(range(N_SCANS))
    assert [s.name for s in roots] == ["slam_wrapper.scan"] * N_SCANS + ["slam_wrapper.finish"]
    assert {s.scan for s in rec.spans} == set(range(N_SCANS))


def test_self_time_is_the_duration_less_the_union_of_the_children(recorded):
    planted = Recording([
        Span("a", 0, 100, -1, 0, "t"), Span("b", 10, 40, 0, 0, "t"),
        Span("c", 30, 60, 0, 0, "t"), Span("d", 35, 38, 1, 0, "t"),
        Span("e", 90, 120, 0, 0, "t")], {}, 0, 0)
    assert planted.self_ns() == [100 - (60 - 10) - 10, 30 - 3, 30, 3, 30]
    rec, _, _ = recorded
    own = rec.self_ns()
    assert min(own) >= 0
    roots = [i for i, s in enumerate(rec.spans) if s.parent < 0]
    # Spans of one thread tile their root: the self times add up to it.
    assert sum(own) == sum(rec.spans[i].end_ns - rec.spans[i].start_ns for i in roots)


def test_the_off_state_reads_no_clock_and_allocates_nothing(param_file, seq, monkeypatch):
    telemetry.turn_off()
    reads = []
    clock = timeutil._time.perf_counter_ns
    monkeypatch.setattr(timeutil._time, "perf_counter_ns",
                        lambda: reads.append(1) or clock())
    slam = SlamWrapper(tcfg.load_parameters_from_file(param_file), device="cpu")
    for s, t in zip(seq.scans[:3], seq.timestamps[:3]):
        slam.process_scan_pipelined(s, t)
    assert reads == []
    assert telemetry.span("odometry.scan") is NULL_SPAN
    assert telemetry.stage("register") is NULL_SPAN and telemetry.pull() is NULL_SPAN
    monkeypatch.setattr(timeutil._time, "perf_counter_ns", clock)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with telemetry.span("mapper.dispatch"):
                with telemetry.stage("normals.layout"):
                    telemetry.count("pulls")
                    telemetry.set_scan(3)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, timeutil.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert [d for d in grown if d.size_diff > 0] == []


def test_pulls_by_span_sum_to_the_host_syncs(recorded):
    rec, syncs, _ = recorded
    pulls = {k[0]: n for k, n in rec.counters.items() if k[1] == "pulls"}
    assert sum(pulls.values()) == syncs > 0
    assert pulls["gn_loop.gicp"] > 0 and pulls["mapper.finalize"] > 0
    spans = [s for s in rec.spans if s.name == "pull"]
    assert len(spans) == syncs
    by_parent = {}
    for s in spans:
        parent = rec.spans[s.parent].name
        by_parent[parent] = by_parent.get(parent, 0) + 1
    assert by_parent == pulls


def test_the_closure_counters_agree_with_the_accepted_closures():
    """A closure found, solved and applied through the wrapper, on the
    submaps of ``tests/test_torch_loop_closure.py``."""
    import test_torch_loop_closure as lc
    from open3d_slam_tpu.utils import config as jcfg
    from open3d_slam_torch.models.submap_collection import TimestampedSubmapId
    from open3d_slam_torch.utils import pointcloud as tpc
    from torch_parity import JaxTriplets, to_torch_params
    p = to_torch_params(jcfg.load_parameters_from_file(jcfg.config_path("velodyne_puck16.yaml")))
    p.capacities.submap_points = lc.MAP_CAP
    p.capacities.feature_cloud = lc.FEATURE_CAP
    p.capacities.max_submaps, p.capacities.max_constraints = 16, 32
    slam = SlamWrapper(p, device="cpu")
    coll = slam.submaps
    for k in range(1, 5):
        coll.create_new_submap(lc._T(x=lc.CENTERS[min(k, 3)][0], y=lc.CENTERS[min(k, 3)][1]))
    rng = np.random.default_rng(11)
    pts, nrm = lc._yard(rng)
    seen = rng.uniform(size=len(pts)) < 0.55
    for k, c in enumerate(lc.CENTERS):
        keep = (np.linalg.norm(pts[:, :2] - c, axis=1) < 9.0) & seen
        q, n = pts[keep], nrm[keep]
        if k == 3:
            q, n = q @ lc.DRIFT[:3, :3].T + lc.DRIFT[:3, 3], n @ lc.DRIFT[:3, :3].T
        q = q + rng.normal(0, 0.01, q.shape)
        s = coll.get_submap(k)
        s.map_cloud = tpc.from_numpy(q.astype(np.float32), capacity=lc.MAP_CAP,
                                     normals=n.astype(np.float32), device="cpu")
        s.compute_submap_center()
        coll.adjacency.add_edge(k, k + 1)
    coll.compute_features([TimestampedSubmapId(k, float(k)) for k in range(4)])
    slam.place_recognition.draw_triplets = JaxTriplets()
    slam.loop_closure_candidates = [TimestampedSubmapId(3, 3.5)]
    telemetry.start_recording()
    try:
        slam._advance_loop_closures(drain=True)
        slam.check_if_optimized_graph_available()
    finally:
        rec = telemetry.stop_recording()
    count = {}
    for (_, name), n in rec.counters.items():
        count[name] = count.get(name, 0) + n
    accepted = slam.get_health()["n_loop_closures_accepted"]
    assert accepted >= 1 and slam.n_optimizations_applied == 1
    assert count["closure.jobs_started"] == 1
    assert count["closure.jobs_with_constraints"] == 1
    assert count["closure.constraints_accepted"] == accepted
    names = [s.name for s in rec.spans]
    for want in ("closure.advance", "closure.start", "closure.ransac", "closure.refine",
                 "optimization.round", "optimization.flush_constraints",
                 "optimization.odometry_constraints", "optimization.build",
                 "optimization.solve"):
        assert want in names, want
    # The round follows the job's last phase, inside the job's advance.
    round_ = names.index("optimization.round")
    assert rec.spans[round_].parent == names.index("closure.advance")


def test_the_worker_thread_keeps_its_own_stack(param_file, seq):
    slam = SlamWrapper(tcfg.load_parameters_from_file(param_file), device="cpu")
    driver = AsyncSlamDriver(slam)
    telemetry.start_recording()
    driver.start_workers()
    try:
        for s, t in zip(seq.scans[:4], seq.timestamps[:4]):
            while driver.is_backpressured():
                time.sleep(0.001)
            driver.add_range_scan(s, t)
        while len(slam.odometry_buffer) or len(slam.mapping_buffer):
            time.sleep(0.01)
    finally:
        # The worker ends the loop it is in: every scan ingested is mapped.
        driver.stop_workers(finish=False)
        rec = telemetry.stop_recording()
    main = threading.current_thread().name
    worker = [s for s in rec.spans if s.thread == "slam-pipeline"]
    caller = [s for s in rec.spans if s.thread == main]
    assert worker and caller
    assert {s.name for s in caller} >= {"slam_wrapper.ingest"}
    assert not any(s.name.startswith(("odometry.", "mapper.")) for s in caller)
    assert [s.scan for s in caller if s.name == "slam_wrapper.ingest"][:4] == [0, 1, 2, 3]
    for s in rec.spans:
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.thread == s.thread and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    odo = [s for s in worker if s.name == "odometry.scan"]
    assert [s.scan for s in odo] == [0, 1, 2, 3] and all(s.parent < 0 for s in odo)


def test_the_mapping_cli_exports_a_chrome_trace(param_file, tmp_path):
    out = tmp_path / "spans.json"
    t0 = time.time() * 1e6
    assert tcli.main(["--synthetic", "8", "--device", "cpu", "--param", param_file,
                      "--trace-out", str(out), "--save-folder", str(tmp_path)]) == 0
    trace = json.loads(out.read_text())
    events = trace["traceEvents"]
    assert events and all(e["ph"] == "X" for e in events)
    assert all(t0 <= e["ts"] <= time.time() * 1e6 and e["dur"] >= 0 for e in events)
    assert {e["args"]["thread"] for e in events} == {"MainThread"}
    roots = [e for e in events if e["name"] == "slam_wrapper.scan"]
    assert [e["args"]["scan"] for e in roots] == list(range(len(roots))) and roots
    assert any(c[1] == "pulls" for c in trace["otherData"]["counters"])


def test_stats_totals_and_the_timing_print(param_file, seq, capsys):
    telemetry.turn_off()
    p = tcfg.load_parameters_from_file(param_file)
    p.mapper.is_print_timing_statistics = True
    before = telemetry.totals()
    slam = SlamWrapper(p, device="cpu")
    assert telemetry.state == timeutil.STATS
    for s, t in zip(seq.scans[:3], seq.timestamps[:3]):
        slam.process_scan_pipelined(s, t)
    slam.finish_processing()
    after = telemetry.totals()
    n0 = before.get("slam_wrapper.scan", (0, 0.0))[0]
    assert after["slam_wrapper.scan"][0] == n0 + 3 and after["slam_wrapper.scan"][1] > 0
    assert "[o3d_slam_torch] slam_wrapper.scan: avg" in capsys.readouterr().err


def test_threads_keep_their_own_stacks_and_counts_under_contention():
    """More threads than cores open spans and count at once, the
    interpreter switching threads as often as it can: no count is lost and
    every span nests inside its parent on its own thread."""
    n_threads, n_spans = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    telemetry.start_recording()
    try:
        def work(k):
            telemetry.set_scan(k)
            for _ in range(n_spans):
                with telemetry.span("mapper.dispatch"):
                    with telemetry.stage("register"):
                        telemetry.count("pulls")
        threads = [threading.Thread(target=work, args=(k,), name=f"w{k}")
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        rec = telemetry.stop_recording()
        sys.setswitchinterval(switch)
    assert rec.counters[("mapper.register", "pulls")] == n_threads * n_spans
    for k in range(n_threads):
        mine = [s for s in rec.spans if s.thread == f"w{k}"]
        assert len(mine) == 2 * n_spans and {s.scan for s in mine} == {k}
        for s in mine:
            if s.name == "mapper.register":
                p = rec.spans[s.parent]
                assert p.name == "mapper.dispatch" and p.thread == s.thread
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_recorded_spans_are_on_the_unix_clock():
    telemetry.start_recording()
    a = time.time_ns()
    with telemetry.span("slam_wrapper.scan"):
        time.sleep(0.002)
    b = time.time_ns()
    rec = telemetry.stop_recording()
    (s,) = [s for s in rec.spans if s.name == "slam_wrapper.scan"]
    assert a <= s.start_ns < s.end_ns <= b
    assert abs(rec.drift_ns) < 1_000_000
