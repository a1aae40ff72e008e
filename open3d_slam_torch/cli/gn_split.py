"""Where the device time of one Gauss-Newton iteration goes.

    python -m open3d_slam_torch.cli.gn_split [--reps 3] [--fold] [--out FILE]
    python open3d_slam_torch/cli/gn_split.py --root DIR [...]

Runs the fused GN loops of K1 (GICP, ``icp_generalized``) and K4
(point-to-plane, ``icp_point_to_plane`` and ``batched_icp_point_to_plane``)
as the main path runs them, graphed, at the main path's shapes: GICP at
1 x 16384 x 16384 (scan to scan) and 1 x 4096 x 65536 (scan to map),
point-to-plane at 1 x 16384 x 16384 and at 64 x 2048 x 32768 (global
localization's refine stage, one shared target).  The clouds are scans of
a seeded ``SyntheticWorld``; the targets and query orders are made once,
outside the loops.  With both relative thresholds 0 no element converges,
so a call takes exactly its ``max_iterations``.  Calls of ``LONG`` and
``SHORT`` iterations run under ``torch.profiler``, ``--reps`` of each after
one warm-up call (the graphs' capture); every device operation (kernel,
copy, memset), by its short name, is summed over each profile, and one
iteration's device us and count are (long - short) / (reps (LONG - SHORT)).
The device's busy us per iteration (the union of its intervals) is taken
the same way.

``--fold`` also times, at each shape, the loop's two launches after the
sweep (``gn_step``, then ``gn_apply`` at the poses it returns) against one
launch that folds them (``cli/gn_fold.cu``, built into ``_build/split/``):
each design's iteration (the sweep included) run ``LONG`` and ``SHORT``
times in one CUDA graph each, captured as the loops capture theirs
(``gn_graph.capture``), the replays timed between CUDA events in turns
(two-launch, fold, fold, two-launch) over ``ROUNDS`` rounds; one
iteration's us is the median of (long - short) / (LONG - SHORT).  Both
designs start from the same state and must end with the same bits, and
each iteration's graph nodes are listed.

``--root DIR`` imports ``open3d_slam_torch`` from another checkout (a ``git
archive`` of an earlier commit unpacked under ``_archive/``), so one script
measures two trees in one call: run this file by its path for that (a tree
without ``cuda_gn_step`` takes no ``--fold``).  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

LONG, SHORT = 20, 4
ROUNDS = 5                  # --fold: rounds of turns (two-launch, fold, fold, two-launch)
SHAPES = (("gicp", 1, 16384, 16384), ("gicp", 1, 4096, 65536),
          ("p2l", 1, 16384, 16384), ("p2l", 64, 2048, 32768))
CORR = 1.0                  # correspondence distance, m


def short_name(key: str) -> str:
    """"ns::(anonymous namespace)::nn_sweep<...>(...)" -> "nn_sweep"."""
    key = re.sub(r"\(anonymous namespace\)::", "", key)
    if key.startswith("void "):
        key = key[5:]
    return re.split(r"[<(]", key)[0].split("::")[-1][:60]


def problem(kind, b, m, n, dev, seed=0):
    """(``call(max_iterations)``: one loop at B x M x N, run to its limit;
    the loop's own pieces, as ``registration``'s fused loops hold them:
    (``sweep(points, cov6)``, the source points, their covariances or None,
    the valid count, the initial poses, the retraction))."""
    import numpy as np
    import torch
    from open3d_slam_torch.io import datasets
    from open3d_slam_torch.ops import cuda_gicp, cuda_icp, hashgrid, nn_layout, normals
    from open3d_slam_torch.ops import registration as reg
    from open3d_slam_torch.utils import pointcloud as pclib, se3

    world = datasets.SyntheticWorld(datasets.SyntheticWorldConfig(
        extent=35.0, n_ground=120000, n_walls=60000, n_pillars=40000, seed=seed))
    T = np.eye(4)
    T[:3, 3] = [5.0, 3.0, 1.5]
    tgt = world.render_scan(T, max_range=35.0, n_points=n)
    src = world.render_scan(T, max_range=25.0, n_points=m) + np.array(
        [0.1, -0.05, 0.0], np.float32)
    t_pc = normals.estimate_normals(pclib.from_numpy(tgt, capacity=n, device=dev), 1.0,
                                    max_nn=20)
    s_pc = normals.estimate_normals(pclib.from_numpy(src, capacity=m, device=dev), 1.0,
                                    max_nn=20)
    grid = hashgrid.build(t_pc, CORR)
    order = nn_layout.query_order(s_pc.points, s_pc.mask)
    eye = torch.eye(4, device=dev)
    maskf = s_pc.mask.to(torch.float32)[..., None].contiguous()
    r2 = reg._r2(CORR, dev)
    if kind == "gicp":
        covs = normals.covariances_from_normals(t_pc)[grid.order.long()]
        s_covs = normals.covariances_from_normals(s_pc)
        prepared = cuda_gicp.prepare_target(grid.points_sorted, covs,
                                            grid.hashes_sorted != hashgrid.INT32_MAX)
        td, tv, t_layout = prepared
        layout = nn_layout.SweepLayout(t_layout, order)
        pieces = (lambda pts, qc: cuda_gicp.gicp_normal_eq(pts, maskf, qc, td, tv, r2, None,
                                                           layout),
                  s_pc.points[None], cuda_gicp.cov6_from_full(s_covs)[None],
                  s_pc.mask.to(torch.float32).sum(), eye[None], True)
        return (lambda k: reg.icp_generalized(s_pc, s_covs, grid, covs, eye, CORR, k, 0.0,
                                              0.0, prepared=prepared, source_order=order),
                pieces)
    prepared = reg.point_to_plane_target(grid)
    t_t, tn_t, tc, tv, t_layout = prepared
    layout = nn_layout.SweepLayout(t_layout, order)

    def sweep(pts, _):
        return cuda_icp.p2l_normal_eq(pts, maskf, t_t, tn_t, tc, tv, r2, layout)
    n_src = s_pc.mask.to(torch.float32).sum()
    if b == 1:
        return (lambda k: reg.icp_point_to_plane(s_pc, grid, eye, CORR, k, 0.0, 0.0,
                                                 prepared=prepared, source_order=order),
                (sweep, s_pc.points[None], None, n_src, eye[None], False))
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(scale=0.02, size=(b, 3)),
                         rng.normal(scale=0.2, size=(b, 3))], 1).astype(np.float32)
    inits = se3.se3_exp(torch.from_numpy(xi).to(dev)).contiguous()
    return (lambda k: reg.batched_icp_point_to_plane(s_pc, grid, inits, CORR, k, 0.0,
                                                     0.0, prepared=prepared,
                                                     source_order=order),
            (sweep, s_pc.points, None, n_src, inits, False))


def profile(call, k, reps):
    """(device us by short name, events by short name, busy us) summed over
    ``reps`` calls of ``k`` iterations."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            res = call(k)
        torch.cuda.synchronize()
    if int(res.num_iterations.max()) != k:
        raise RuntimeError("a loop stopped before its limit")
    cuda = torch.autograd.DeviceType.CUDA
    us, count = collections.Counter(), collections.Counter()
    spans = []
    for e in prof.events():
        if e.device_type == cuda:
            name = short_name(e.name)
            us[name] += e.time_range.end - e.time_range.start
            count[name] += 1
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return us, count, busy


FOLD_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gn_fold.cu")


def build_fold():
    """``cli/gn_fold.cu`` compiled into ``_build/split/`` with
    ``cuda_build``'s flags and ``csrc`` on the include path: its library,
    and its ``ptxas`` line."""
    from open3d_slam_torch.ops import cuda_build
    from open3d_slam_torch.utils import device as devmod
    nvcc = devmod.nvcc_path()
    if nvcc is None:
        raise RuntimeError("gn_split: nvcc not found")
    split_dir = os.path.join(cuda_build.BUILD_DIR, "split")
    os.makedirs(split_dir, exist_ok=True)
    lib = os.path.join(split_dir, "libgn_fold.so")
    proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR, "-o", lib,
                           FOLD_SOURCE], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"gn_split: nvcc failed for gn_fold.cu:\n{proc.stdout}")
    return ctypes.CDLL(lib), cuda_build.ptxas_summary(proc.stdout)


def fold_launcher(lib):
    """The folded kernel as a function of (out, n_src, P, prev, points, cov6,
    exp_retraction) -> (the next state, the source moved to its P, the
    covariances rotated or None): ``gn_step`` and then ``gn_apply`` at the
    poses it returns, in one launch."""
    import torch
    from open3d_slam_torch.ops import cuda_build
    from open3d_slam_torch.ops.gn_graph import GNState
    fn = lib.gn_fold_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p,
                   ctypes.c_longlong] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 +
                   [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2 +
                   [ctypes.c_int] * 2 + [ctypes.c_void_p])

    def fold(out, n_src, P, prev, points, cov6, exp_retraction):
        b, m, dev = P.shape[0], points.shape[-2], P.device
        state = GNState(torch.empty((b, 4, 4), device=dev), torch.empty((b, 4, 4), device=dev),
                        torch.empty(b, device=dev), torch.empty(b, device=dev),
                        torch.empty(b, dtype=torch.int32, device=dev),
                        torch.empty(b, dtype=torch.bool, device=dev))
        moved = torch.empty((b, m, 3), device=dev)
        rot = None if cov6 is None else torch.empty((b, m, 6), device=dev)
        pb = points.stride(0) if points.dim() == 3 and points.shape[0] > 1 else 0
        cb = 0 if cov6 is None or cov6.shape[0] == 1 else cov6.stride(0)
        vec = m % 4 == 0 and pb % 4 == 0 and cb % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (points, moved) + (
                () if cov6 is None else (cov6, rot)))
        n_src = n_src.reshape(-1)
        err = fn(out.data_ptr(), *out.stride(), n_src.data_ptr(),
                 n_src.stride(0) if n_src.shape[0] > 1 else 0, P.data_ptr(),
                 *(t.data_ptr() for t in (prev.fit, prev.rmse, prev.it, prev.done)),
                 *(t.data_ptr() for t in state[:2]), *(t.data_ptr() for t in state[2:]),
                 b, int(exp_retraction), 0.0, 0.0, points.data_ptr(), pb,
                 0 if cov6 is None else cov6.data_ptr(), cb, moved.data_ptr(),
                 0 if rot is None else rot.data_ptr(), m, int(vec),
                 torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(err, "gn_fold")
        return state, moved, rot
    return fold


def replay_us(graph, reps: int) -> float:
    """Mean us of ``reps`` back-to-back replays of a captured graph, between
    two CUDA events."""
    import torch
    graph.graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def fold_compare(pieces, fold, dev, reps: int = 20) -> dict:
    """Per-iteration us of the two-launch and the folded design on the loop
    ``pieces`` (``problem``), the thresholds 0 (no element converges), and
    whether both end with the same bits; each iteration's graph nodes."""
    import torch
    from open3d_slam_torch.ops import cuda_gn_step, gn_graph
    sweep, points, cov6, n_src, inits, exp = pieces
    s0 = cuda_gn_step.gn_step(sweep(*cuda_gn_step.gn_apply(inits, points, cov6)), n_src,
                              inits, None, exp)
    moved0 = cuda_gn_step.gn_apply(s0.P, points, cov6)

    def two_launch(k):
        s = s0
        for _ in range(k):
            s = cuda_gn_step.gn_step(sweep(*cuda_gn_step.gn_apply(s.P, points, cov6)), n_src,
                                     s.P, s, exp)
        return s

    def folded(k):
        s, (pts, qc) = s0, moved0
        for _ in range(k):
            s, pts, qc = fold(sweep(pts, qc), n_src, s.P, s, points, cov6, exp)
        return s

    designs = {"two_launch": two_launch, "fold": folded}
    nodes = {name: gn_graph.graph_nodes(lambda f=f: f(1), dev)[0]
             for name, f in designs.items()}
    graphs = {(name, k): gn_graph.capture(lambda f=f, k=k: f(k), dev)
              for name, f in designs.items() for k in (LONG, SHORT)}
    us = {name: [] for name in designs}
    for _ in range(ROUNDS):
        for name in ("two_launch", "fold", "fold", "two_launch"):
            long_us = replay_us(graphs[(name, LONG)][0], reps)
            short_us = replay_us(graphs[(name, SHORT)][0], reps)
            us[name].append((long_us - short_us) / (LONG - SHORT))
    a, b = graphs[("two_launch", LONG)][1], graphs[("fold", LONG)][1]
    torch.cuda.synchronize()
    return {"us": {name: statistics.median(v) for name, v in us.items()},
            "spread": {name: max(v) - min(v) for name, v in us.items()},
            "same_bits": all(torch.equal(x, y) for x, y in zip(a, b)),
            "nodes": {name: [short_name(n) for n in v] for name, v in nodes.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import open3d_slam_torch from this checkout")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fold", action="store_true",
                    help="also time the folded step (cli/gn_fold.cu) against two launches")
    ap.add_argument("--out", default=None, help="append one JSON line per shape here")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from open3d_slam_torch.ops import cuda_build
    from open3d_slam_torch.utils import device as devmod

    if not torch.cuda.is_available():
        print("gn_split: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name_power = devmod.nvidia_smi_name_power()
    root = os.path.dirname(os.path.dirname(os.path.abspath(cuda_build.__file__)))
    print(f"gn_split: package {root}; {name_power}", flush=True)
    cuda_build.build_all()
    fold = None
    if args.fold:
        lib, ptxas = build_fold()
        fold = fold_launcher(lib)
        print(f"gn_fold.cu: {ptxas}", flush=True)
    for kind, b, m, n in SHAPES:
        call, pieces = problem(kind, b, m, n, dev)
        call(LONG)                       # builds, captures the graphs
        call(SHORT)
        long_us, long_n, long_busy = profile(call, LONG, args.reps)
        short_us, short_n, short_busy = profile(call, SHORT, args.reps)
        per = args.reps * (LONG - SHORT)
        rows = sorted(((name, (long_us[name] - short_us[name]) / per,
                        (long_n[name] - short_n[name]) / per) for name in long_us),
                      key=lambda r: -r[1])
        rows = [r for r in rows if abs(r[2]) > 1e-9 or abs(r[1]) > 1e-3]
        busy = (long_busy - short_busy) / per
        total = sum(r[1] for r in rows)
        print(f"{kind} {b}x{m}x{n}: device us per GN iteration: sum of operations "
              f"{total:.2f}, busy {busy:.2f}, operations per iteration "
              f"{sum(r[2] for r in rows):.2f}; {name_power}")
        for name, us, cnt in rows:
            print(f"  {us:9.3f} us  {cnt:6.2f} x  {name}")
        line = {"root": root, "shape": [kind, b, m, n], "name_power": name_power,
                "sum_us": total, "busy_us": busy, "ops": rows}
        if fold is not None:
            line["fold"] = got = fold_compare(pieces, fold, dev)
            print(f"{kind} {b}x{m}x{n}: us per iteration in one graph (median of "
                  f"{2 * ROUNDS} turns, spread): two launches "
                  f"{got['us']['two_launch']:.3f} ({got['spread']['two_launch']:.3f}), "
                  f"folded {got['us']['fold']:.3f} ({got['spread']['fold']:.3f}); same bits "
                  f"{got['same_bits']}; nodes an iteration {got['nodes']}; {name_power}",
                  flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
