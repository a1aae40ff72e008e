"""Mapping cells: ``SlamWrapper.process_scan_pipelined`` in a closed loop over
recorded logs, one after another, as an offline user maps a stack of logs.

Each log is a fixed number of laps of the traffic's route (its first lap maps
the site, the later laps revisit it), mapped by a fresh ``SlamWrapper``, and
ends with ``finish_processing``; the next log starts at once.  A log's
length is fixed, and not the window's, because the pose graph keeps every
round's odometry nodes (``OptimizationProblem.build_optimization_problem``):
one long run outgrows the configured graph however fast the program is
(PERF.md, Open questions).

Set-up renders the logs on the device, builds every kernel, builds the first
log's wrapper, runs its warm-up (``SlamWrapper.warmup`` on the scans the
reference skips, which captures the loops' graphs and runs each closure
function once at the configured capacities) and its first lap, which the
traffic needs: revisits start after it.  The window then feeds one scan
after another, each as soon as the call before it returns, and times every
call.  After the window ``finish_processing`` lands the scan still in flight,
every pose of the window is held against the true poses the scans were
rendered from (``perfbench/reference/poses.py``), and every pose-graph solve
of the window against the reference's solve of the same graph
(``perfbench/reference/pose_graph.py``).

With ``trace`` the window is split in two halves: the first with the layers'
spans synchronised (``core.StageTimer``), the second under
``torch.profiler`` with no added synchronisation.
"""
from __future__ import annotations

import math
import time

import numpy as np

from perfbench import core
from perfbench.reference import pose_graph as ref_pg
from perfbench.reference import poses as ref

DRIFT_SCANS = 20        # 2 s of a 10 Hz sensor
REACH_M = 20.0          # half the yard: a correction's rotation shows at the map's edge


def _layers(st, mods):
    """The layer spans, from the entry point down (PERF.md's layer list)."""
    SlamWrapper, LidarOdometry, Mapper, SubmapCollection, registration = mods
    st.wrap(SlamWrapper, "process_scan_pipelined", lambda *a: "slam_wrapper")
    st.wrap(LidarOdometry, "add_range_scan_async", lambda *a: "odometry")
    for attr in ("preprocess_scan", "dispatch_range_measurement",
                 "finalize_range_measurement"):
        st.wrap(Mapper, attr, lambda *a: "mapper")
    st.wrap(SubmapCollection, "insert_scan", lambda *a: "submap")
    for loop in ("_icp_gicp_fused_batch", "_icp_p2l_fused_batch"):
        st.wrap(registration, loop, lambda *a: "gn_loop")
    st.wrap(SlamWrapper, "compute_features_if_ready", lambda *a: "closure")
    st.wrap(SlamWrapper, "_advance_loop_closures", lambda *a: "closure")
    # An accepted closure's round: constraints, the pose-graph build and solve.
    st.wrap(SlamWrapper, "_finish_loop_closure",
            lambda self, constraints: "optimization" if constraints else "closure")


class _Log:
    """One log being mapped: its wrapper, the poses it produced by time, and
    where the window started in it."""

    def __init__(self, SlamWrapper, params, device, seq, first: int):
        self.seq, self.next, self.window_from = seq, first, None
        self.slam = SlamWrapper(params, device=device)
        self.produced = _record_poses(self.slam.mapper.map_to_range_sensor_buffer)
        self.closures_before_window = 0
        self.closures = 0

    def open_window(self):
        self.window_from = self.next
        self.closures_before_window = self.slam.n_loop_closures_accepted

    def done(self) -> bool:
        return self.next >= len(self.seq)

    def close_window(self):
        self.closures = self.slam.n_loop_closures_accepted - self.closures_before_window


def run(files: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run of the cell; returns its set-up time, end-to-end numbers or
    trace, checks, memory peak and notes.  What it patches into the
    program's classes is taken out again however it ends."""
    undo = []
    try:
        return _run(files, seed, seconds, trace, device, t_start, undo)
    finally:
        for fn in reversed(undo):
            fn()


def _run(files, seed, seconds, trace, device, t_start, undo) -> dict:
    import torch
    from open3d_slam_torch.models import slam_wrapper as sw
    from open3d_slam_torch.models.mapper import Mapper
    from open3d_slam_torch.models.optimization import OptimizationProblem
    from open3d_slam_torch.models.odometry import LidarOdometry
    from open3d_slam_torch.models.submap_collection import SubmapCollection
    from open3d_slam_torch.ops import cuda_build, gn_graph, registration
    from open3d_slam_torch.utils import config as cfg_mod, device as devmod

    config, traffic = files["config"], files["traffic"]
    sensor = config["sensor"]
    params = cfg_mod.load_parameters(config["slam_parameters"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        cuda_build.build_all()      # every kernel, so none builds inside the window
        if trace:       # before any capture: the launch check reads the graphs' nodes
            undo.append(core.keep_graph_nodes(gn_graph))
    solves = _SolveRecorder(OptimizationProblem)
    undo.append(solves.restore)
    marks = [("imports and kernels", time.perf_counter())]

    n_skip = int(config["skip_first_scans"])
    lap = float(traffic["trajectory"]["period_s"]) * float(traffic["rate_hz"])
    n_setup = n_skip + int(math.ceil(float(traffic["setup_laps"]) * lap))
    log_scans = n_skip + int(math.ceil(float(config["log_laps"]) * lap))
    wanted = n_setup + float(traffic["render_scans_per_window_s"]) * seconds
    n_logs = int(math.ceil(wanted / (log_scans - n_skip)))
    seqs = core.generator(traffic)(traffic, sensor, seed, n_logs, log_scans, device)
    marks.append((f"render {n_logs} logs of {log_scans} scans", time.perf_counter()))

    log = _Log(sw.SlamWrapper, params, device, seqs[0], n_skip)
    log.slam.warmup(scans=seqs[0].scans[:n_skip], timestamps=seqs[0].timestamps[:n_skip])
    sync()
    marks.append(("warm-up", time.perf_counter()))
    for i in range(n_skip, n_setup):
        log.slam.process_scan_pipelined(seqs[0].scans[i], seqs[0].timestamps[i])
    log.next = n_setup
    sync()
    marks.append((f"first lap ({n_setup - n_skip} scans)", time.perf_counter()))
    graphs_before = gn_graph.captured()
    setup_s = time.perf_counter() - t_start

    mods = (sw.SlamWrapper, LidarOdometry, Mapper, SubmapCollection, registration)
    logs = [log]
    log.open_window()
    solves.recording = True
    call_ms = []
    out = {"setup_s": setup_s, "info": [core.setup_parts(t_start, marks)]}

    def feed(until: float) -> int:
        """Scans until the clock passes ``until``; a finished log is closed
        and the next one started inside the window, as a user's stack of
        logs is mapped."""
        n = 0
        while time.perf_counter() < until:
            cur = logs[-1]
            if cur.done():
                cur.slam.finish_processing()
                cur.close_window()
                if len(logs) == len(seqs):
                    raise RuntimeError(f"the traffic ran out of logs after {n} scans of the "
                                       "window: render more per window second")
                nxt = _Log(sw.SlamWrapper, params, device, seqs[len(logs)], n_skip)
                nxt.open_window()
                logs.append(nxt)
                cur.slam = None
                continue
            pts, ts = cur.seq.scans[cur.next], cur.seq.timestamps[cur.next]
            t = time.perf_counter()
            cur.slam.process_scan_pipelined(pts, ts)
            call_ms.append((time.perf_counter() - t) * 1e3)
            cur.next += 1
            n += 1
        return n

    if not trace:
        t0 = time.perf_counter()
        n = feed(t0 + seconds)
        window_s = time.perf_counter() - t0
        out["e2e"] = {"scans_per_s": core.per_second(n, window_s),
                      "scan_p95_ms": core.p95(call_ms)}
    else:
        half = seconds / 2.0
        st = core.StageTimer(torch, sync)
        _layers(st, mods)
        n1 = feed(time.perf_counter() + half)
        st.restore()
        spans = st.spans()
        devmod.host_syncs.count = 0
        profile = core.profiled_half(torch, lambda: feed(time.perf_counter() + half),
                                     lambda st: _layers(st, mods), sync, out["info"])
        syncs = devmod.host_syncs.count
        out["trace"] = {"kind": "mapping", "spans": spans, "synced_scans": n1,
                        "profiled_scans": profile["units"], "host_syncs": syncs,
                        "profile": profile}
    if gn_graph.captured() != graphs_before:
        out["info"].append(f"graphs captured inside the window: {graphs_before} -> "
                           f"{gn_graph.captured()} (keys, graphs)")
    sync()
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
    last = logs[-1]
    last.slam.finish_processing()
    last.close_window()
    solves.recording = False
    health = last.slam.get_health()
    for g in logs:
        g.slam = None
    t = time.perf_counter()
    p = params.mapper.global_optimization
    graph = ref_pg.solve_cost_share(solves.solves, p.loop_closure_preference,
                                   p.edge_prune_threshold, p.reference_node, REACH_M)
    out["attempted"] = len(call_ms)
    out["failed"] = 0
    out["checks"] = _checks(files["checks"], logs, n_skip, sum(g.closures for g in logs),
                            graph["share"])
    out["info"].append(f"window: {len(call_ms)} scans over {len(logs)} logs (the first from "
                       f"scan {n_setup}, the last to scan {last.next - 1}), closures accepted "
                       f"{[g.closures for g in logs]}, health {health}")
    out["info"].append(
        f"pose graph: {graph['solves']} solves in the window solved again in "
        f"{time.perf_counter() - t:.1f} s; cost share missed {graph['share']!r}; the "
        f"program's corrections up to {graph['gap_m']!r} m from the reference's, which "
        f"moved up to {graph['correction_m']!r} m; pruned edges "
        f"that differ {graph['kept_differs']}; nodes {solves.nodes()}")
    return out


class _SolveRecorder:
    """While ``recording``, keeps each pose-graph solve the program makes
    (``OptimizationProblem.solve``): the graph it was handed, as the solve
    reads it (the poses it starts from, every edge), the poses it returned
    and the loop-closure edges it kept.  Host copies of host lists: the
    solve's own pull has already brought its answer back."""

    def __init__(self, cls):
        self.cls, self.fn = cls, cls.solve
        self.recording = False
        self.solves = []
        fn, rec = self.fn, self

        def solve(opt):
            if not rec.recording:
                return fn(opt)
            n = len(opt.node_poses)
            done = opt.node_poses_optimized or []
            start = np.array([done[i] if i < len(done) else opt.node_poses[i]
                              for i in range(n)], np.float64)
            edges = opt.odometry_constraints + opt.loop_closure_constraints
            graph = ref_pg.Graph(
                start, np.array([c.source_submap_idx for c in edges], np.int64),
                np.array([c.target_submap_idx for c in edges], np.int64),
                np.array([c.source_to_target for c in edges], np.float64).reshape(-1, 4, 4),
                np.array([c.information_matrix for c in edges], np.float64).reshape(-1, 6, 6),
                np.array([not c.is_odometry_constraint for c in edges], bool))
            closures = list(opt.loop_closure_constraints)
            out = fn(opt)
            kept = [True] * len(opt.odometry_constraints) + [
                any(c is k for k in opt.loop_closure_constraints) for c in closures]
            rec.solves.append({"graph": graph, "kept": np.array(kept),
                               "result": np.array(opt.node_poses_optimized, np.float64)})
            return out

        cls.solve = solve

    def nodes(self):
        return [len(s["graph"].poses) for s in self.solves]

    def restore(self):
        self.cls.solve = self.fn


def _record_poses(buf) -> dict:
    """Every pose the mapper pushes into its trajectory buffer, by time, as
    the buffer holds it (the buffer itself keeps only its newest poses)."""
    produced = {}
    push = buf.push

    def recorded(time, transform):
        out = push(time, transform)
        held = buf.latest_measurement()
        produced[float(held.time)] = np.array(held.transform, np.float64).reshape(4, 4)
        return out

    buf.push = recorded
    return produced


def _checks(limits: dict, logs, n_skip: int, closures: int, solve_cost: float) -> list:
    """Every pose of the window against the true poses, the closures the
    window accepted, and the window's pose-graph solves against the
    reference's.  A SLAM run's poses drift from the truth by design, and a
    closure's correction moves them at once, so the poses are judged by the
    motion they give over ``DRIFT_SCANS`` scans against the true motion (the
    window's median).  A closure's correction is small beside that drift, so
    each solve is judged by the cost it minimises against the reference's
    solve of the same graph."""
    drifts, missing = [], 0
    for log in logs:
        truth = ref.in_first_frame(log.seq.ground_truth[n_skip:])
        idx = range(log.window_from, log.next)
        have = [i for i in idx if float(log.seq.timestamps[i]) in log.produced]
        missing += len(idx) - len(have)
        est = np.array([log.produced[float(log.seq.timestamps[i])] for i in have])
        est = est.reshape(-1, 4, 4)
        tru = truth[[i - n_skip for i in have]].reshape(-1, 4, 4)
        drifts.append(ref.relative_gaps(est, tru, DRIFT_SCANS)[0])
    drift = np.concatenate(drifts)
    values = {
        "drift_2s_median_m": float(np.median(drift)) if len(drift) else math.inf,
        "poses_missing": float(missing),
        "closures_accepted": float(closures),
        "solve_cost_share": float(solve_cost),
    }
    return [dict(name=k, value=values[k], op=limits[k]["op"], limit=limits[k]["limit"])
            for k in limits]
