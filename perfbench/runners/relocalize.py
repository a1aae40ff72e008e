"""Relocalization cells: ``SlamMapInitializer.relocalize`` in a closed loop
over kidnapped-robot queries in a saved site map.

Set-up renders the site map and the queries on the device, builds every
kernel, loads the map through ``SlamMapInitializer.initialize`` (localization
mode, as ``cli/localization.py`` runs it) and relocalizes the traffic's
warm-up queries, which capture the funnel's graphs.  The window then
relocalizes one query after another, each as soon as the call before it
returns, and times every call.  Each call keeps its stages' outputs on the
device (``keep``); they are pulled only after the window, where every pose
is held against its planted pose and a seeded sample of the window's
queries against the plain reference (``perfbench/reference/relocalize.py``),
on the site map as the generator made it with the reference's own normals:
the coarse stage from the program's hypotheses, the mid stage from the
program's best coarse poses, the rank scores at the program's coarse poses,
the final stage from the program's refined winner, the fitness at the
program's pose, and the program's voxelized query against the raw scan's
voxel centroids.

With ``trace`` the window is split in two halves: the first with the
funnel's stages synchronised (the program's ``profile`` of each call), the
second under ``torch.profiler`` with no added synchronisation and the
program's spans recorded.  ``core.profiled_half`` keeps the profiler's
trace to itself, and the program's spans are read against it here: the
trace is kept by a subclass of ``core.Trace`` put in its place for the
half's length.

A program without ``SlamMapInitializer.relocalize`` cannot run the cell:
the run stops before anything is rendered, with exit code 2.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np

from perfbench import core, program_spans
from perfbench.generators import lidar
from perfbench.reference import relocalize as ref

SAMPLE = 16                 # window queries held against the reference
COARSE_SAMPLE = 4           # of them, those whose coarse stage is run again
COARSE_ITERS, MID_ITERS, FINAL_ITERS = 10, 12, 10   # the funnel's iterations
LOCALIZED_M, LOCALIZED_DEG = 0.5, 5.0
SCAN_GAP_REACH_M = 1.0      # how far the scan check looks for a centroid
STAGE_SPANS = {f"relocalize.{s}" for s in
               ("query", "prep", "coarse", "rank", "mid", "refine", "final")}


def run(files: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run of the cell; returns its set-up time, end-to-end numbers or
    trace, checks, memory peak and notes.  What it patches into the harness
    is taken out again however it ends."""
    from open3d_slam_torch.models.map_initializer import SlamMapInitializer
    if not hasattr(SlamMapInitializer, "relocalize"):
        print("perfbench: the program in this checkout has no relocalization entry point "
              "(SlamMapInitializer.relocalize), so it cannot run a relocalization cell",
              file=sys.stderr)
        raise SystemExit(2)
    undo = []
    try:
        return _run(files, seed, seconds, trace, device, t_start, undo)
    finally:
        for fn in reversed(undo):
            fn()


def _run(files, seed, seconds, trace, device, t_start, undo) -> dict:
    import torch
    from open3d_slam_torch.models.map_initializer import SlamMapInitializer
    from open3d_slam_torch.models.slam_wrapper import SlamWrapper
    from open3d_slam_torch.ops import cuda_build, gn_graph
    from open3d_slam_torch.utils import config as cfg_mod, device as devmod

    config, traffic = files["config"], files["traffic"]
    params = cfg_mod.load_parameters(config["slam_parameters"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        cuda_build.build_all()      # every kernel, so none builds inside the window
        if trace:       # before any capture: the launch check reads the graphs' nodes
            undo.append(core.keep_graph_nodes(gn_graph))
    marks = [("imports and kernels", time.perf_counter())]

    q = traffic["queries"]
    n_warm = int(q["warmup"])
    n_queries = n_warm + int(math.ceil(float(q["render_per_window_s"]) * seconds))
    site = core.generator(traffic)(traffic, config, seed, n_queries, device)
    marks.append((f"render the site map ({len(site.map_points)} points from "
                  f"{site.map_scans} sweeps) and {n_queries} queries", time.perf_counter()))

    slam = SlamWrapper(params, device=device)
    init = SlamMapInitializer(slam)
    init.initialize(site.map_points)
    sync()
    marks.append(("map loaded", time.perf_counter()))
    for i in range(n_warm):
        init.relocalize(site.scans[i])
    sync()
    marks.append((f"warm-up ({n_warm} queries)", time.perf_counter()))
    graphs_before = gn_graph.captured()
    setup_s = time.perf_counter() - t_start

    out = {"setup_s": setup_s, "info": [core.setup_parts(t_start, marks)]}
    records = []            # (query, pose, fitness, the stages kept on the device)
    call_ms = []
    state = {"next": n_warm, "stage_ms": None}

    def feed(until: float) -> int:
        """Queries until the clock passes ``until``; with ``state["stage_ms"]``
        a dict, each call's synchronised stage ms are added to it."""
        n = 0
        while time.perf_counter() < until:
            i = state["next"]
            if i >= len(site.scans):
                raise RuntimeError(f"the traffic ran out of queries after {n} of the window: "
                                   "render more per window second")
            keep, prof = {}, ({} if state["stage_ms"] is not None else None)
            t = time.perf_counter()
            T, fitness = init.relocalize(site.scans[i], keep=keep, profile=prof)
            call_ms.append((time.perf_counter() - t) * 1e3)
            records.append((i, T, fitness, keep))
            if prof is not None:
                for k, v in prof.items():
                    state["stage_ms"][k] = state["stage_ms"].get(k, 0.0) + v
            state["next"] += 1
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
        state["stage_ms"] = {}
        n1 = feed(time.perf_counter() + half)
        stage_ms, state["stage_ms"] = state["stage_ms"], None
        out["trace"] = _profiled(torch, feed, half, sync, devmod, init, out["info"])
        out["trace"].update(synced_queries=n1, stage_ms=stage_ms)
    if gn_graph.captured() != graphs_before:
        out["info"].append(f"graphs captured inside the window: {graphs_before} -> "
                           f"{gn_graph.captured()} (keys, graphs)")
    sync()
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
    held = slam.mapper.submaps.get_active_submap().map_cloud
    t = time.perf_counter()
    values, notes = _judge(records, site, params, seed, device)
    out["attempted"] = len(call_ms)
    out["failed"] = 0
    out["checks"] = [dict(name=k, value=values[k], op=c["op"], limit=c["limit"])
                     for k, c in files["checks"].items()]
    out["info"].append(f"window: {len(call_ms)} queries (from query {n_warm}); the site map "
                       f"{len(site.map_points)} points, the program holds "
                       f"{int(held.mask.sum())}")
    out["info"].append(f"reference: {notes} in {time.perf_counter() - t:.1f} s")
    return out


class _KeptTrace:
    """Puts a subclass of ``core.Trace`` in its place that keeps the
    instance it builds (``core.profiled_half`` does not return it)."""

    def __init__(self):
        self.trace, self.cls = None, core.Trace
        keeper = self

        class Kept(core.Trace):
            def __init__(self, torch, prof):
                super().__init__(torch, prof)
                keeper.trace = self

        core.Trace = Kept

    def restore(self):
        core.Trace = self.cls


def _profiled(torch, feed, half, sync, devmod, init, info) -> dict:
    """The traced window's second half under ``core.profiled_half``, with
    the program's spans recorded and read against the profiler's trace."""
    from open3d_slam_torch.utils.timeutil import telemetry
    rec = {}

    def recorded() -> int:
        telemetry.start_recording()
        try:
            return feed(time.perf_counter() + half)
        finally:
            rec["spans"] = telemetry.stop_recording()

    def layers(st):
        st.wrap(type(init), "relocalize", lambda *a: "relocalize")

    kept = _KeptTrace()
    devmod.host_syncs.count = 0
    try:
        profile = core.profiled_half(torch, recorded, layers, sync, info)
    finally:
        kept.restore()
    syncs = devmod.host_syncs.count
    trace, recording = kept.trace, rec["spans"]
    window = trace.span_of("pb.window")
    replays = {owner for _, _, api, owner in trace.launch_calls() if "GraphLaunch" in api}
    program = program_spans.read(recording, trace.device, trace.host, window, replays)
    info += program_spans.info_lines(program)
    program_spans.check_clock(program)
    idle = idle_by_stage(recording, trace.device, window)
    info.append(f"device idle by relocalize stage (s): "
                f"{ {k: round(v / 1e3, 4) for k, v in sorted(idle.items())} }")
    return {"kind": "relocalize", "profiled_queries": profile["units"], "host_syncs": syncs,
            "profile": profile, "idle_ms_by_stage": idle,
            "counters": program["counters"], "pulls_by_span": program["pulls_by_span"]}


def idle_by_stage(recording, device, window) -> dict:
    """The device's idle gaps in ``window`` (ms), each credited to the
    funnel's stage span (``relocalize.<stage>``, or ``relocalize.query``
    itself) that holds the innermost main-thread span at the gap's middle:
    a stage's GN loops, normals and pulls count for the stage; gaps under
    no such span are left out."""
    spans = program_spans._us(recording.spans)
    main = [s for s in spans if s[5] == program_spans.MAIN_THREAD]
    gaps = program_spans.idle_gaps(device, window)
    out = {}
    for (a, b), span in zip(gaps, program_spans.innermost(main, [0.5 * (a + b)
                                                                for a, b in gaps])):
        while span is not None and span[2] not in STAGE_SPANS:
            span = spans[span[3]] if span[3] >= 0 else None
        if span is not None:
            key = span[2][len("relocalize."):]
            out[key] = out.get(key, 0.0) + (b - a) / 1e3
    return out


def _valid(cloud):
    return cloud.points[cloud.mask]


def _translation_gaps(a, b):
    """|t_a - t_b| (m) of each pair of (B, 4, 4) poses."""
    import torch
    a, b = (torch.as_tensor(x).detach().to("cpu", torch.float64) for x in (a, b))
    return torch.linalg.norm(a[:, :3, 3] - b[:, :3, 3], dim=1)


class _Maps:
    """The reference's maps of the site as the generator made it, each made
    once: the site map itself and the coarse and mid stages' voxel maps,
    with the reference's own normals."""

    def __init__(self, site, params, device):
        import torch
        icp = params.mapper.scan_matcher.icp
        self.knn, self.radius, self.device = icp.knn, icp.max_distance_knn, device
        self.points = torch.as_tensor(site.map_points).to(device)
        self.world = ref.Map(self.points, self.knn, self.radius, device)
        self._voxel = {}

    def voxel(self, edge: float) -> ref.Map:
        if edge not in self._voxel:
            self._voxel[edge] = ref.Map(ref.voxel_centroids(self.points, edge), self.knn,
                                        self.radius, self.device)
        return self._voxel[edge]


def _judge(records, site, params, seed: int, device) -> tuple:
    """The checks' values: every window pose against its planted pose, and
    a seeded sample of the window's queries against the reference, on the
    site map as the generator made it, with the reference's own normals:
    the coarse stage from the program's hypotheses (on the first
    ``COARSE_SAMPLE`` of the sample), the mid stage from the program's
    ``top_k`` coarse poses, the rank scores at the program's coarse poses,
    the final stage from the program's refined winner, the fitness at the
    returned pose, and the voxelized query against the raw scan."""
    import torch
    gaps = [ref.pose_gap(T, site.poses[i]) for i, T, _, _ in records]
    localized = [t <= LOCALIZED_M and r <= LOCALIZED_DEG for t, r in gaps]
    rng = np.random.default_rng(lidar.stream_seed(seed, 3))
    pick = sorted(rng.choice(len(records), min(SAMPLE, len(records)), replace=False))
    maps = _Maps(site, params, device)
    v = dict.fromkeys(("rank_score_gap_max", "coarse_pose_gap_m", "mid_pose_gap_m",
                       "final_pose_gap_m", "fitness_gap_max", "scan_gap_m"), 0.0)
    mid_max = rot_max = 0.0
    voxel = max(params.mapper.scan_processing.voxel_size, 1e-3)
    for n, j in enumerate(pick):
        i, T, fitness, keep = records[j]
        d = keep["max_corr"]
        if n < COARSE_SAMPLE:
            c = keep["coarse_corr"]
            coarse = ref.point_to_plane(maps.voxel(max(0.5, c / 4.0)), _valid(keep["scan_small"]),
                                        keep["hypotheses"], c, COARSE_ITERS)
            v["coarse_pose_gap_m"] = max(v["coarse_pose_gap_m"], float(
                _translation_gaps(coarse["T"], keep["coarse_T"]).median()))
        c = keep["mid_corr"]
        mid = ref.point_to_point(maps.voxel(max(0.4, c / 5.0)), _valid(keep["scan_mid"]),
                                 keep["coarse_T"][keep["best_idx"]], c, MID_ITERS)
        mid_gap = _translation_gaps(mid["T"], keep["mid_T"])
        v["mid_pose_gap_m"] = max(v["mid_pose_gap_m"], float(mid_gap.median()))
        mid_max = max(mid_max, float(mid_gap.max()))
        score = ref.rank_scores(maps.world, _valid(keep["scan_rank"]), keep["coarse_T"], d)
        v["rank_score_gap_max"] = max(v["rank_score_gap_max"],
                                      float((score - keep["rank_score"].double()).abs().max()))
        full = _valid(keep["scan_full"])
        final = ref.point_to_plane(maps.world, full, keep["refined_T"][None], d, FINAL_ITERS)
        t, r = ref.pose_gap(final["T"][0], T)
        v["final_pose_gap_m"] = max(v["final_pose_gap_m"], t)
        rot_max = max(rot_max, r)
        fit, _ = ref.evaluate(maps.world, full, torch.as_tensor(T)[None], d)
        v["fitness_gap_max"] = max(v["fitness_gap_max"], abs(float(fit[0]) - fitness))
        raw = torch.as_tensor(site.scans[i]).to(device)
        cents = ref.Map(ref.voxel_centroids(raw, voxel), device=device)
        d2, _ = cents.nearest(full.double(), SCAN_GAP_REACH_M)
        v["scan_gap_m"] = max(v["scan_gap_m"], float(d2.median().sqrt()))
    v["localized_share"] = float(np.mean(localized)) if localized else 0.0
    worst = max(gaps, key=lambda g: g[0]) if gaps else None
    notes = (f"{len(pick)} sampled queries of {len(records)} (the coarse stage on "
             f"{min(COARSE_SAMPLE, len(pick))}); pose errors against the planted poses: median "
             f"{float(np.median([g[0] for g in gaps])) if gaps else math.nan:.4f} m, worst "
             f"{worst}; {len(localized) - sum(localized)} queries not localized; the mid stage's "
             f"largest hypothesis gap {mid_max:.6f} m, the final stage's rotation gap "
             f"{rot_max:.6f} deg")
    return v, notes
