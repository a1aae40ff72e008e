"""Chip smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and a checkout of this repository (it imports
``open3d_slam_torch`` from beside this file; it imports nothing of JAX or of
``open3d_slam_tpu``).  In order it:

  1. prints the card's name and power limit (``nvidia-smi``) and the CUDA
     version;
  2. builds every hand-written kernel from ``open3d_slam_torch/csrc`` (one
     ``nvcc`` per source, started together);
  3. replays the simulated ``vlp16_yard_circle`` sequence through
     ``SlamWrapper.process_scan_pipelined`` on the card, at the full
     ``velodyne_puck16`` capacities with loop closures and undistortion off
     (the first slice's path), with every kernel's launch count set to 0
     just before and read just after, and checks the trajectory against the
     simulator's ground truth (ATE) and, on the same rendered scans, against
     the poses that path has always given;
  4. replays the first scans once more in sequential mode and checks that
     the pipelined and sequential poses agree;
  5. replays the same scans with the full ``velodyne_puck16`` configuration
     as users run it (loop closures on, undistortion on), counts reset
     again, and checks that a closure was accepted and applied, the ATE,
     and that every kernel of that path ran;
  6. localizes, through ``cli.localization.main`` as a VLP-16 user runs it,
     the first scans of step 3 against the map of step 3's submap 0 (saved
     as a PCD, the scans as a sequence folder) from step 3's first pose, and
     checks every pose against step 3's;
  7. global localization at the width of the JAX package's config 4
     (``bench.py``'s ``bench_multistart_localization``): 1024 hypotheses on
     a 32768-point structured scene, five planted 8192-point scans, each
     localized within 0.5 m and 5 degrees;
  8. replays the first scans of step 3 with point-to-plane ICP for both
     registrations (the ``SlamParameters`` default) and checks the ATE;
  9. holds each kernel against its plain PyTorch version on the card, on the
     inputs the runs last gave it at each of its shapes, and times both
     next to the least time the card could take (the bound); for K1 and K4
     also the device time of each of a call's launches (``torch.profiler``),
     for K2's prepass also the matmul + topk chain it replaced, and for the
     sweeps the share of pairs their skip leaves;
  10. prints a ``kernels`` JSON line, the card line, and last the device
      JSON.

Steps 6 to 8 each set every launch count to 0 just before and read it just
after, and fail if a kernel of their path did not run.

It exits non-zero, and prints no result line, on any failure, without a
card, or when run outside the repository.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import re
import sys
import time

ATE_LIMIT_M = 0.15          # trajectory error allowed against ground truth
SEQUENCE = "vlp16_yard_circle"
N_SKIP = 5                  # clouds the reference skips; used as warmup
N_DETERMINISM = 10          # scans replayed again in sequential mode
# The closures-off replay's poses on the scans this sequence renders to on
# the card's host (both digests are printed; another host's math library
# may render other scans, and then only the ATE is held).  The K2 moments
# kernel's summation order is part of them.
SCANS_SHA1 = "c7037044da48c50c"
POSES_SHA1 = "9a8aedaf9f6df5a6"
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 200_000_000  # ~0.1 s of device clock: longer than any queueing
LOC_SCANS = 30              # scans localized against submap 0's map
LOC_TOL_M, LOC_TOL_DEG = 0.10, 1.0
GLOBAL_HYPOTHESES = 1024    # bench.py's config 4
GLOBAL_MAP, GLOBAL_SCAN = 32768, 8192
GLOBAL_SEEDS = (101, 102, 103, 104, 105)   # seed 100 warms up
GLOBAL_TOL_M, GLOBAL_TOL_DEG = 0.5, 5.0
P2L_SCANS = 100


def fail(msg: str):
    print(f"CHIP SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each between two
    CUDA events, after one warm-up launch.  The launches queue up behind a
    device-side sleep, so the events time the device work alone and not the
    host's Python between launches."""
    import statistics
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def launch_us(fn, reps: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel that ``fn``
    launches, by kernel name, from ``torch.profiler`` over ``reps`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA

    def name(key):     # "nn::(anonymous namespace)::nn_sweep(...)" -> "nn_sweep"
        return re.sub(r"\(anonymous namespace\)::", "", key).split("(")[0].split("::")[-1]

    return {name(e.key): round(e.self_device_time_total / reps, 2)
            for e in prof.key_averages() if e.device_type == cuda}


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Recorder:
    """Stands in for a kernel wrapper during the replay and keeps, for each
    launch key (kernel, shape) the wrapper counted, the last inputs it
    launched on; keys in ``frozen`` keep theirs (a shape the replays ran
    stays held at the replays' inputs when a later step runs it too).  It
    counts nothing itself: the launch counts are the wrappers' own, in
    ``cuda_build.launches``."""

    def __init__(self, cuda_build, module, name):
        self.cuda_build, self.module, self.name = cuda_build, module, name
        self.wrapper = getattr(module, name)
        self.inputs = {}
        self.frozen = set()

    def __call__(self, *args, **kwargs):
        before = dict(self.cuda_build.launches)
        out = self.wrapper(*args, **kwargs)
        for key, n in self.cuda_build.launches.items():
            if n != before.get(key, 0) and key not in self.frozen:
                self.inputs[key] = (args, kwargs)
        return out

    def install(self):
        setattr(self.module, self.name, self)

    def remove(self):
        setattr(self.module, self.name, self.wrapper)


GICP_TOL = 1e-5     # Gram entry vs sqrt(|G_ii||G_jj|); d2 sum vs itself
P2L_TOL = 1e-5      # the same for K4
MOMENTS_TOL = 1e-5  # moment vs the sum of |feature| over its neighbours


def swept_pairs(q_pts, q_mask_f, layout, r2):
    """(pairs the exact skip leaves to sweep, splits) of one K1 or K4 call:
    (query group, target tile) pairs within r of each other, at the
    kernel's granularity (``nn_layout.tile_need``), times the pairs in
    each; the splits ``nn_layout.plan_splits`` gives the launch."""
    from open3d_slam_torch.ops import nn_layout
    need = nn_layout.tile_need(q_pts, q_mask_f, layout, r2)
    b, groups, tiles = need.shape
    splits = nn_layout.plan_splits(groups, b, tiles, q_pts.device)
    return int(need.sum().item()) * nn_layout.GROUP * nn_layout.TILE, splits


def gicp_entry(cuda_gicp, shape, n_launch, args, kwargs):
    import torch
    from open3d_slam_torch.ops import nn_layout
    bound = inspect.signature(cuda_gicp.gicp_normal_eq).bind(*args, **kwargs)
    bound.apply_defaults()
    q_pts, q_mask_f, q_cov6, td, tv, r2, t_aabb, layout = bound.args
    out_k = cuda_gicp.gicp_normal_eq(*args, **kwargs)
    out_p = cuda_gicp.gicp_normal_eq_plain(*bound.args)
    torch.cuda.synchronize()
    n_in_k, n_in_p = int(out_k[0, 7, 0].item()), int(out_p[0, 7, 0].item())
    dis = cuda_gicp.plain_disagreement(out_k, out_p)
    ok = (dis["n_in_equal"] and dis["rest_equal"] and dis["gram"] <= GICP_TOL
          and dis["d2s"] <= GICP_TOL)
    ms = time_ms(lambda: cuda_gicp.gicp_normal_eq(*args, **kwargs), 20)
    plain = time_ms(lambda: cuda_gicp.gicp_normal_eq_plain(*bound.args), 3)
    per_launch = launch_us(lambda: cuda_gicp.gicp_normal_eq(*args, **kwargs))
    b, m, n = shape
    if layout is None:
        layout = nn_layout.layout_for(q_pts, q_mask_f, td, tv)
    pairs, splits = swept_pairs(q_pts, q_mask_f, layout, r2)
    n_valid = int((q_mask_f > 0).sum().item())
    ops = pairs * 8 + n_valid * 200      # 8 flops per distance; ~200 per row
    n_bytes = 4 * (m * (3 + 1 + 6) + n * (9 + 1) + 8 * 128)
    b_ms, b_by = bound_ms(n_bytes, ops)
    print(f"K1 gicp_normal_eq {m}x{n}: n_in kernel {n_in_k} plain {n_in_p}, "
          f"padding equal {dis['rest_equal']}, Gram err {dis['gram']:.3e} of "
          f"sqrt(|G_ii||G_jj|), d2 sum rel err {dis['d2s']:.3e} (tol "
          f"{GICP_TOL:g} each), max abs err {dis['max_abs_err']:.3e}, "
          f"{ms:.4f} ms vs plain {plain:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}; swept {pairs} of {b * m * n} pairs, "
          f"{100.0 * pairs / (b * m * n):.2f}%, {splits} splits); device us per "
          f"launch {json.dumps(per_launch)}")
    return ok, {"name": f"gicp_normal_eq[{m}x{n}]", "route": "cuda",
                "source": "open3d_slam_torch/csrc/gicp.cu",
                "replaces": "open3d_slam_tpu/ops/pallas_gicp.py:166",
                "launches": n_launch, "max_abs_err": dis["max_abs_err"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}


def k2_swept_pairs(query_points, points, mask, layout, r2, centred):
    """Pairs a K2 kernel's skip leaves at its granularity (64 queries x 64
    support points) for per-query r2 (M,), with the kernel's boxes: those
    of the coordinates as given (the prepass) or centred on the layout's
    centroid, as the moments kernel centres them."""
    import torch
    from open3d_slam_torch.ops import nn_layout
    q, target = query_points, layout.target
    if centred:
        c = layout.centroid
        q = query_points - c
        boxes = target.boxes.clone()
        boxes[:, 0:3] -= c
        boxes[:, 3:6] -= c
        target = target._replace(boxes=boxes)
    ones = torch.ones((q.shape[0], 1), device=q.device)
    need = nn_layout.tile_need(q[None], ones, nn_layout.SweepLayout(target, layout.query_order),
                               r2)
    return int(need.sum().item()) * nn_layout.GROUP * nn_layout.TILE


def kth_entry(cuda_normals, shape, n_launch, args, kwargs):
    import torch
    bound = inspect.signature(cuda_normals.kth_neighbor_d2_within).bind(*args, **kwargs)
    bound.apply_defaults()
    query_points, points, mask, k, radius, layout = bound.args
    layout = layout or cuda_normals.normals_layout(query_points, points, mask)
    m, n = shape
    k = min(k, n)
    cap = float(torch.tensor(float(radius)) ** 2)
    got = cuda_normals.kth_neighbor_d2_within(*bound.args)
    want = cuda_normals.kth_neighbor_d2_within_plain(query_points, points, mask, k, cap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = torch.equal(got, want)
    ms = time_ms(lambda: cuda_normals.kth_neighbor_d2_within(*bound.args), 20)
    plain = time_ms(lambda: cuda_normals.kth_neighbor_d2_within_plain(
        query_points, points, mask, k, cap), 3)
    chain = time_ms(lambda: cuda_normals.kth_neighbor_d2_at(query_points, points, mask, k), 3)
    # The least sweep: the (group, tile) pairs within each query's final
    # min(r^2, d_k^2) (the kernel also sweeps the tiles that overlap the
    # group's box and those within the expansion form's rounding margin).
    pairs = k2_swept_pairs(query_points, points, mask, layout, want, centred=False)
    # 8 flops a pair (the dot's 3 multiply-adds, |t|^2 shared, the sum, the
    # 2x and the difference) and the compare; queries, support and mask
    # read once, the output written once.
    b_ms, b_by = bound_ms(12 * m + 13 * n + 4 * m, 9.0 * pairs)
    print(f"K2 kth_neighbor_d2_within {m}x{n} (k {k}): equal to plain {ok}, max abs err "
          f"{err:.3e} (exact required), {ms:.4f} ms vs plain {plain:.4f} ms, the old "
          f"matmul + topk chain {chain:.4f} ms, bound {b_ms:.5f} ms ({b_by}; pairs within "
          f"the final threshold {pairs} of {m * n}, {100.0 * pairs / (m * n):.2f}%)")
    return ok, {"name": f"kth_neighbor_d2_within[{m}x{n}]", "route": "cuda",
                "source": "open3d_slam_torch/csrc/normals.cu",
                "replaces": "open3d_slam_tpu/ops/pallas_normals.py:153",
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}


def moments_entry(cuda_normals, shape, n_launch, args, kwargs):
    import torch
    bound = inspect.signature(cuda_normals.radius_moments_at).bind(*args, **kwargs)
    bound.apply_defaults()
    query_points, points, mask, radius, layout = bound.args
    layout = layout or cuda_normals.normals_layout(query_points, points, mask)
    out_k = cuda_normals.radius_moments_at(*bound.args)
    inputs = cuda_normals.moment_inputs(query_points, points, mask, radius)
    dis = cuda_normals.plain_disagreement(out_k, *inputs)
    torch.cuda.synchronize()
    ok = dis["count_equal"] and dis["moments"] <= MOMENTS_TOL
    ms = time_ms(lambda: cuda_normals.radius_moments_at(*bound.args), 20)
    plain = time_ms(lambda: cuda_normals.radius_moments_plain(*inputs), 3)
    m, n = shape
    pairs = k2_swept_pairs(query_points, points, mask, layout, inputs[4], centred=True)
    # 8 flops a pair the skip leaves, 10 adds and 6 products per neighbour;
    # queries, radii, support and mask read once, the (M, 16) output written.
    ops = pairs * 8 + dis["neighbours"] * 16
    n_bytes = 12 * m + 4 * m + 13 * n + 64 * m
    b_ms, b_by = bound_ms(n_bytes, ops)
    print(f"K2 radius_moments_at {m}x{n}: counts equal {dis['count_equal']} "
          f"({dis['neighbours']} neighbours), moment err {dis['moments']:.3e} "
          f"of the sum of |feature| (tol {MOMENTS_TOL:g}), max abs err "
          f"{dis['max_abs_err']:.3e}, {ms:.4f} ms vs plain {plain:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}; swept {pairs} of {m * n} pairs, "
          f"{100.0 * pairs / (m * n):.2f}%)")
    return ok, {"name": f"radius_moments_at[{m}x{n}]", "route": "cuda",
                "source": "open3d_slam_torch/csrc/normals.cu",
                "replaces": "open3d_slam_tpu/ops/pallas_normals.py:82",
                "launches": n_launch, "max_abs_err": dis["max_abs_err"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}


def knn_entry(cuda_knn, shape, n_launch, args, kwargs):
    import torch
    got_i, got_d = cuda_knn.nn_argmin(*args, **kwargs)
    inputs = cuda_knn.knn_inputs(*args, **kwargs)
    want_i, want_d = cuda_knn.nn_argmin_plain(*inputs)
    torch.cuda.synchronize()
    same_inf = torch.equal(torch.isinf(got_d), torch.isinf(want_d))
    fin = torch.isfinite(want_d)
    err = float((got_d[fin] - want_d[fin]).abs().max()) if bool(fin.any()) else 0.0
    ok = torch.equal(got_i, want_i) and same_inf and err == 0.0
    ms = time_ms(lambda: cuda_knn.nn_argmin(*args, **kwargs), 20)
    plain = time_ms(lambda: cuda_knn.nn_argmin_plain(*inputs), 3)
    m, n = shape
    # 9 flops a pair: the 3-term dot, |q|^2 + |t|^2, the 2x and the
    # subtraction, and the compare.  Each input read once, each output
    # written once.
    b_ms, b_by = bound_ms(4 * (m * 4 + n * 4 + m * 2), 9.0 * m * n)
    n_valid = int(torch.isfinite(inputs[3]).sum())
    print(f"K3 nn_argmin {m}x{n}: indices equal {torch.equal(got_i, want_i)}, "
          f"d2 max abs err {err:.3e} (exact required), {n_valid} valid targets, "
          f"{ms:.4f} ms vs plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return ok, {"name": f"nn_argmin[{m}x{n}]", "route": "cuda",
                "source": "open3d_slam_torch/csrc/knn.cu",
                "replaces": "open3d_slam_tpu/ops/pallas_knn.py:58",
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}


def icp_entry(cuda_icp, shape, n_launch, args, kwargs):
    import torch
    from open3d_slam_torch.ops import nn_layout
    bound = inspect.signature(cuda_icp.p2l_normal_eq).bind(*args, **kwargs)
    bound.apply_defaults()
    inputs = bound.args
    out_k = cuda_icp.p2l_normal_eq(*inputs)
    out_p = cuda_icp.p2l_normal_eq_plain(*inputs)
    torch.cuda.synchronize()
    dis = cuda_icp.plain_disagreement(out_k, out_p)
    ok = (dis["n_in_equal"] and dis["rest_equal"] and dis["gram"] <= P2L_TOL
          and dis["d2s"] <= P2L_TOL)
    ms = time_ms(lambda: cuda_icp.p2l_normal_eq(*inputs), 20)
    plain = time_ms(lambda: cuda_icp.p2l_normal_eq_plain(*inputs), 3)
    per_launch = launch_us(lambda: cuda_icp.p2l_normal_eq(*inputs))
    b, m, n = shape
    q_pts, q_mask_f, t_t, tv, r2, layout = (inputs[0], inputs[1], inputs[2], inputs[5],
                                            inputs[6], inputs[7])
    if layout is None:
        layout = nn_layout.layout_for(q_pts, q_mask_f, t_t, tv)
    pairs, splits = swept_pairs(q_pts, q_mask_f, layout, r2)
    n_in = float(out_p[:, 7, 0].sum())
    # 8 flops a pair the skip leaves (3 differences, 3 squares, 2 adds; the
    # compare), ~70 a row of inliers (residual, Jacobian, 28 products and
    # sums).  Each input read once: sources, mask, 8 target rows (x, y, z,
    # n, c, valid).
    ops = 8.0 * pairs + 70.0 * n_in
    n_bytes = 4 * (b * m * 3 + q_mask_f.numel() + 8 * (t_t.numel() // 3) + b * 8 * 128)
    b_ms, b_by = bound_ms(n_bytes, ops)
    print(f"K4 p2l_normal_eq {b}x{m}x{n}: n_in kernel {int(out_k[:, 7, 0].sum())} "
          f"plain {int(n_in)}, padding equal {dis['rest_equal']}, Gram err "
          f"{dis['gram']:.3e} of sqrt(|G_ii||G_jj|), d2 sum rel err {dis['d2s']:.3e} "
          f"(tol {P2L_TOL:g} each), max abs err {dis['max_abs_err']:.3e}, "
          f"{ms:.4f} ms vs plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
          f"swept {pairs} of {b * m * n} pairs, {100.0 * pairs / (b * m * n):.2f}%, "
          f"{splits} splits); device us per launch {json.dumps(per_launch)}")
    return ok, {"name": f"p2l_normal_eq[{b}x{m}x{n}]", "route": "cuda",
                "source": "open3d_slam_torch/csrc/icp.cu",
                "replaces": "open3d_slam_tpu/ops/pallas_icp.py:137",
                "launches": n_launch, "max_abs_err": dis["max_abs_err"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}


def pose_error(a, b):
    """(translation m, rotation deg) between two 4x4 poses."""
    import numpy as np
    d = np.linalg.inv(a) @ b
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(np.degrees(np.arccos(cos)))


def missing_kernels(cuda_build, counts, names):
    """The kernels of ``names`` that ``counts`` saw no launch of."""
    return [k for k in names if cuda_build.launch_total(k, counts) == 0]


def cli_localization(folder, poses, cuda_build, cfg, localization):
    """Step 6: ``cli.localization.main`` on the saved map and scans from
    step 3's first pose, counts reset just before.  Returns (ok, counts)."""
    import math
    import numpy as np
    T0 = poses[0]
    R = T0[:3, :3]
    xyzrpy = (T0[0, 3], T0[1, 3], T0[2, 3], math.atan2(R[2, 1], R[2, 2]),
              math.asin(max(-1.0, min(1.0, -R[2, 0]))), math.atan2(R[1, 0], R[0, 0]))
    out = os.path.join(folder, "poses.npz")
    argv = ["--map", os.path.join(folder, "map.pcd"), "--param",
            cfg.config_path("velodyne_puck16.yaml"), "--sequence",
            os.path.join(folder, "scans"), "--initial-pose",
            *[f"{float(v):.12f}" for v in xyzrpy], "--save-poses", out]
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    rc = localization.main(argv)
    wall = time.perf_counter() - t0
    counts = dict(cuda_build.launches)
    ok = rc == 0
    errs = []
    if ok:
        got = np.load(out)["poses"]
        ok = len(got) == LOC_SCANS
        errs = [pose_error(a, b) for a, b in zip(poses[:LOC_SCANS], got)]
    worst_t = max((e[0] for e in errs), default=float("inf"))
    worst_r = max((e[1] for e in errs), default=float("inf"))
    print(f"CLI localization: rc {rc}, {len(errs)} of {LOC_SCANS} poses in "
          f"{wall:.2f} s (map load and normals included); largest gap to the "
          f"replay {worst_t:.4f} m, {worst_r:.4f} deg (limits {LOC_TOL_M} m, "
          f"{LOC_TOL_DEG} deg); launches {json.dumps(shape_counts(counts))}",
          flush=True)
    ok = ok and worst_t <= LOC_TOL_M and worst_r <= LOC_TOL_DEG
    missing = missing_kernels(cuda_build, counts, ("gicp_normal_eq", "kth_neighbor_d2_within",
                                                   "radius_moments_at"))
    if missing:
        print(f"CLI localization never launched {missing}", file=sys.stderr)
    return ok and not missing, counts


def global_localization(cuda_build, cfg, datasets, pclib, multi_start):
    """Step 7: config 4 of the JAX package's bench at its own sizes.  The
    warm-up pose runs before the counts are reset.  Returns (ok, counts)."""
    import numpy as np
    rng = np.random.default_rng(4)
    map_pts = datasets.structured_scene(rng, GLOBAL_MAP)
    params = cfg.SlamParameters()
    params.mapper.scan_matcher.icp.max_correspondence_distance = 1.0
    params.mapper.scan_processing.voxel_size = 0.3
    map_pc = pclib.from_numpy(map_pts, capacity=GLOBAL_MAP, device="cuda")

    def localize(seed, profile=None):
        pts, T_true = datasets.planted_scan(map_pts, np.random.default_rng(seed),
                                            GLOBAL_SCAN)
        scan = pclib.from_numpy(pts, capacity=GLOBAL_SCAN, device="cuda")
        t0 = time.perf_counter()
        T, fit = multi_start.global_localize(scan, map_pc, params,
                                             num_hypotheses=GLOBAL_HYPOTHESES,
                                             profile=profile)
        return time.perf_counter() - t0, T, T_true, fit

    localize(100)
    cuda_build.launches.clear()
    times, errs = [], []
    for seed in GLOBAL_SEEDS:
        dt, T, T_true, fit = localize(seed)
        times.append(dt)
        errs.append(pose_error(T_true, T))
        print(f"  planted pose {seed}: {dt * 1e3:.2f} ms, fitness {fit:.4f}, "
              f"t_err {errs[-1][0]:.4f} m, rot err {errs[-1][1]:.4f} deg")
    counts = dict(cuda_build.launches)
    stages = {}
    localize(GLOBAL_SEEDS[0], profile=stages)
    p50 = float(np.median(times))
    good = sum(e[0] < GLOBAL_TOL_M and e[1] < GLOBAL_TOL_DEG for e in errs)
    print(f"global localization: {good} of {len(errs)} planted poses within "
          f"{GLOBAL_TOL_M} m and {GLOBAL_TOL_DEG} deg, {GLOBAL_HYPOTHESES} "
          f"hypotheses on {GLOBAL_MAP} map points, per-localization p50 "
          f"{p50 * 1e3:.2f} ms, {GLOBAL_HYPOTHESES / p50:.1f} hypotheses/s; stage "
          f"ms (one synchronised run) {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
          f"launches {json.dumps(shape_counts(counts))}", flush=True)
    missing = missing_kernels(cuda_build, counts,
                              ("p2l_normal_eq", "nn_argmin", "kth_neighbor_d2_within",
                               "radius_moments_at"))
    if missing:
        print(f"global localization never launched {missing}", file=sys.stderr)
    return good == len(errs) and not missing, counts


def shape_counts(counts):
    return {f"{k}{list(s)}": c for (k, s), c in sorted(counts.items())}


def replay(slam, scans, cuda_build, devmod):
    """Pipelined replay of ``scans`` with the launch and sync counts set to
    0 just before; returns per-scan ms, wall s (finish included), the
    launch counts by (kernel, shape) and the host syncs."""
    import torch
    cuda_build.launches.clear()
    devmod.host_syncs.count = 0
    per_scan_ms = []
    t_run = time.perf_counter()
    for points, ts in scans:
        t = time.perf_counter()
        slam.process_scan_pipelined(points, ts)
        per_scan_ms.append((time.perf_counter() - t) * 1e3)
    slam.finish_processing()
    torch.cuda.synchronize()
    return (per_scan_ms, time.perf_counter() - t_run, dict(cuda_build.launches),
            devmod.host_syncs.count)


def check_trajectory(slam, seq, n_scans, evaluation):
    """Poses finite and one per scan; returns (poses, ATE, RPE)."""
    import numpy as np
    times, poses = slam.get_trajectory()
    if len(poses) != n_scans or not all(np.isfinite(T).all() for T in poses):
        fail(f"trajectory has {len(poses)} poses for {n_scans} scans or "
             "non-finite entries")
    ate, rpe = evaluation.evaluate_trajectory(
        seq.ground_truth, poses, gt_times=seq.timestamps, est_times=times,
        rpe_delta=10)
    return poses, ate, rpe


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import numpy as np
        from open3d_slam_torch.cli import localization
        from open3d_slam_torch.io import datasets, lidar_sim, pcd
        from open3d_slam_torch.models.slam_wrapper import SlamWrapper
        from open3d_slam_torch.ops import (cuda_build, cuda_gicp, cuda_icp, cuda_knn,
                                           cuda_normals)
        from open3d_slam_torch.parallel import multi_start
        from open3d_slam_torch.utils import config as cfg, device as devmod, evaluation
        from open3d_slam_torch.utils import pointcloud as pclib
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")

    # 1. Device record.
    record = devmod.device_record()
    name_power = record["name_power_limit"]
    if not name_power:
        fail("nvidia-smi did not report the card")
    print(f"device: {json.dumps(record)}", flush=True)

    # 2. Build every kernel, one nvcc per source, all at once.
    t0 = time.perf_counter()
    try:
        logs = cuda_build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"built {', '.join(cuda_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if re.search(r"registers|spill", line):
                print(f"  ptxas[{src}]: {line.strip()}")

    # 3. The first slice's path: the simulated VLP-16 replay at full
    # capacities, loop closures and undistortion off.
    params = cfg.load_parameters_from_file(cfg.config_path("velodyne_puck16.yaml"))
    params.mapper.is_attempt_loop_closures = False
    params.motion_compensation.is_undistort_input_cloud = False
    cap = params.capacities
    print(f"config velodyne_puck16 (loop closures and undistortion off): raw "
          f"{cap.raw_scan}, processed {cap.processed_scan}, map patch "
          f"{cap.map_patch}, submap {cap.submap_points}")
    spec = lidar_sim.BENCHMARK_SEQUENCES[SEQUENCE]
    t0 = time.perf_counter()
    seq = lidar_sim.make_sim_sequence(spec, cache_dir="")
    # The digest tells two runs that rendered different inputs (the host's
    # math library rounds differently on another CPU) from two runs that
    # computed differently on the same inputs.
    digest = hashlib.sha1()
    for s in seq.scans:
        digest.update(np.ascontiguousarray(s, np.float32).tobytes())
    scans_sha1 = digest.hexdigest()[:16]
    print(f"rendered {SEQUENCE}: {len(seq.scans)} scans in "
          f"{time.perf_counter() - t0:.1f} s, sha1 {scans_sha1}", flush=True)
    slam = SlamWrapper(params, device="cuda")
    slam.warmup(scans=seq.scans[:N_SKIP], timestamps=seq.timestamps[:N_SKIP])
    torch.cuda.synchronize()

    recorders = [Recorder(cuda_build, cuda_gicp, "gicp_normal_eq"),
                 Recorder(cuda_build, cuda_normals, "kth_neighbor_d2_within"),
                 Recorder(cuda_build, cuda_normals, "radius_moments_at"),
                 Recorder(cuda_build, cuda_knn, "nn_argmin"),
                 Recorder(cuda_build, cuda_icp, "p2l_normal_eq")]
    for rec in recorders:
        rec.install()
    scans = list(zip(seq.scans, seq.timestamps))[N_SKIP:]
    n = len(scans)
    per_scan_ms, wall_s, by_key, syncs = replay(slam, scans, cuda_build, devmod)
    poses, ate, rpe = check_trajectory(slam, seq, n, evaluation)
    pose_digest = hashlib.sha1(np.stack(poses).astype(np.float64).tobytes()).hexdigest()[:16]
    print(f"replay (closures off): {n} scans, per-scan p50 "
          f"{np.median(per_scan_ms):.2f} ms, mean {wall_s * 1e3 / n:.2f} ms (wall "
          f"{wall_s:.2f} s incl. finish), host syncs {syncs} = {syncs / n:.2f} per "
          f"scan, poses sha1 {pose_digest}")
    print(f"ATE rmse {ate.rmse:.4f} m, mean {ate.mean:.4f} m, max {ate.max:.4f} m; "
          f"RPE trans {rpe.trans_rmse:.4f} m, rot {rpe.rot_rmse_deg:.4f} deg")
    print(f"health: {json.dumps(slam.get_health())}")
    print(f"kernel launches in the closures-off replay: {json.dumps(shape_counts(by_key))}",
          flush=True)
    ok = True
    if ate.rmse > ATE_LIMIT_M:
        print(f"ATE {ate.rmse:.4f} m exceeds {ATE_LIMIT_M} m", file=sys.stderr)
        ok = False
    for rec in recorders[:3]:
        if cuda_build.launch_total(rec.name, by_key) == 0:
            print(f"{rec.name} was never launched", file=sys.stderr)
            ok = False
    for name in ("nn_argmin", "p2l_normal_eq"):
        if cuda_build.launch_total(name, by_key):
            print(f"{name} ran with loop closures off", file=sys.stderr)
            ok = False
    if scans_sha1 == SCANS_SHA1 and pose_digest != POSES_SHA1:
        print(f"poses sha1 {pose_digest} on scans {SCANS_SHA1}: the closures-off "
              f"path gave {POSES_SHA1} before", file=sys.stderr)
        ok = False

    # 4. Pipelined and sequential replay agree.
    seq_slam = SlamWrapper(params, device="cuda")
    for points, ts in scans[:N_DETERMINISM]:
        seq_slam.process_scan(points, ts)
    _, seq_poses = seq_slam.get_trajectory()
    dev = max(float(np.abs(a - b).max()) for a, b in
              zip(poses[:N_DETERMINISM], seq_poses))
    print(f"pipelined vs sequential, first {N_DETERMINISM} poses: max abs "
          f"difference {dev:.3e} (tol 1e-6)")
    if dev > 1e-6:
        ok = False
    # The map of submap 0 and the first scans, for step 6 (in a folder that
    # .gitignore lists).
    loc_dir = os.path.join(here, "o3d_slam_out", "chip_smoke_localization")
    if os.path.isdir(loc_dir):
        import shutil
        shutil.rmtree(loc_dir)
    os.makedirs(loc_dir)
    pcd.write_pcd(os.path.join(loc_dir, "map.pcd"),
                  **pclib.to_numpy(slam.submaps.get_submap(0).map_cloud))
    datasets.save_sequence(datasets.SyntheticSequence(
        scans=[p for p, _ in scans[:LOC_SCANS]], timestamps=[t for _, t in scans[:LOC_SCANS]],
        ground_truth=poses[:LOC_SCANS]), os.path.join(loc_dir, "scans"))
    print(f"saved submap 0 ({slam.submaps.get_num_submaps()} submaps in all) and "
          f"the first {LOC_SCANS} scans, {np.linalg.norm(poses[LOC_SCANS - 1][:3, 3] - poses[0][:3, 3]):.2f} m "
          "of path, for the localization CLI")
    replay_poses = poses
    del slam, seq_slam

    # 5. The full configuration: loop closures and undistortion on.
    full = cfg.load_parameters_from_file(cfg.config_path("velodyne_puck16.yaml"))
    full.motion_compensation.is_undistort_input_cloud = True
    if not full.mapper.is_attempt_loop_closures:
        fail("configs/velodyne_puck16.yaml no longer turns loop closures on")
    print(f"config velodyne_puck16 as users run it: loop closures on, undistortion "
          f"on, feature cloud {full.capacities.feature_cloud}, pose graph "
          f"{full.capacities.max_submaps} nodes / {full.capacities.max_constraints} "
          "edges", flush=True)
    slam = SlamWrapper(full, device="cuda")
    slam.warmup(scans=seq.scans[:N_SKIP], timestamps=seq.timestamps[:N_SKIP])
    torch.cuda.synchronize()
    per_scan_ms, wall_s, full_key, syncs = replay(slam, scans, cuda_build, devmod)
    poses, ate, rpe = check_trajectory(slam, seq, n, evaluation)
    health = slam.get_health()
    q = np.percentile(per_scan_ms, [50, 99])
    print(f"replay (full configuration): {n} scans, per-scan p50 {q[0]:.2f} ms, "
          f"p99 {q[1]:.2f} ms, max {max(per_scan_ms):.2f} ms, mean "
          f"{wall_s * 1e3 / n:.2f} ms (wall {wall_s:.2f} s incl. finish), host "
          f"syncs {syncs} = {syncs / n:.2f} per scan")
    print(f"ATE rmse {ate.rmse:.4f} m, mean {ate.mean:.4f} m, max {ate.max:.4f} m; "
          f"RPE trans {rpe.trans_rmse:.4f} m, rot {rpe.rot_rmse_deg:.4f} deg")
    print(f"health: {json.dumps(health)}")
    print(f"kernel launches in the full replay: {json.dumps(shape_counts(full_key))}",
          flush=True)
    del slam
    if health["n_loop_closures_accepted"] < 1:
        print("no loop closure was accepted", file=sys.stderr)
        ok = False
    if health["n_optimizations_applied"] < 1:
        print("no optimised pose graph was applied", file=sys.stderr)
        ok = False
    if ate.rmse > ATE_LIMIT_M:
        print(f"ATE {ate.rmse:.4f} m exceeds {ATE_LIMIT_M} m", file=sys.stderr)
        ok = False
    for rec in recorders[:4]:
        if cuda_build.launch_total(rec.name, full_key) == 0:
            print(f"{rec.name} was never launched", file=sys.stderr)
            ok = False
    for rec in recorders:
        rec.frozen = set(rec.inputs)

    # 6. The localization CLI as a VLP-16 user runs it.
    good, cli_key = cli_localization(loc_dir, replay_poses, cuda_build, cfg, localization)
    ok = ok and good

    # 7. Global localization at config 4's width.
    good, global_key = global_localization(cuda_build, cfg, datasets, pclib, multi_start)
    ok = ok and good

    # 8. Point-to-plane tracking: step 3's replay over its first scans with
    # PointToPlaneIcp for both registrations.
    p2l = cfg.load_parameters_from_file(cfg.config_path("velodyne_puck16.yaml"))
    p2l.mapper.is_attempt_loop_closures = False
    p2l.odometry.scan_matcher.reg_type = "PointToPlaneIcp"
    p2l.mapper.scan_matcher.scan_to_map_reg_type = "PointToPlaneIcp"
    slam = SlamWrapper(p2l, device="cuda")
    slam.warmup(scans=seq.scans[:N_SKIP], timestamps=seq.timestamps[:N_SKIP])
    torch.cuda.synchronize()
    per_scan_ms, wall_s, p2l_key, syncs = replay(slam, scans[:P2L_SCANS], cuda_build, devmod)
    _, ate, rpe = check_trajectory(slam, seq, P2L_SCANS, evaluation)
    b1 = {s: c for (k, s), c in p2l_key.items() if k == "p2l_normal_eq" and s[0] == 1}
    print(f"point-to-plane tracking: {P2L_SCANS} scans, per-scan p50 "
          f"{np.median(per_scan_ms):.2f} ms, host syncs {syncs / P2L_SCANS:.2f} per scan, "
          f"ATE rmse {ate.rmse:.4f} m (limit {ATE_LIMIT_M} m), RPE trans "
          f"{rpe.trans_rmse:.4f} m; launches {json.dumps(shape_counts(p2l_key))}",
          flush=True)
    del slam
    if ate.rmse > ATE_LIMIT_M or not b1:
        print("point-to-plane tracking: ATE over its limit or no B = 1 launch of "
              "p2l_normal_eq", file=sys.stderr)
        ok = False
    missing = missing_kernels(cuda_build, p2l_key, ("kth_neighbor_d2_within",
                                                    "radius_moments_at"))
    if missing:
        print(f"point-to-plane tracking never launched {missing}", file=sys.stderr)
        ok = False
    for rec in recorders:
        rec.remove()
    phases = (full_key, by_key, cli_key, global_key, p2l_key)
    if set().union(*phases) != {key for rec in recorders for key in rec.inputs}:
        print("a launch key has no recorded inputs", file=sys.stderr)
        ok = False

    # 9. Each kernel against its plain version, at each of its shapes.  The
    # launches of a shape are those of the full replay, else the
    # closures-off replay's, else those of steps 6 to 8 together.
    entries = []
    for rec, entry_fn, mod in ((recorders[0], gicp_entry, cuda_gicp),
                               (recorders[1], kth_entry, cuda_normals),
                               (recorders[2], moments_entry, cuda_normals),
                               (recorders[3], knn_entry, cuda_knn),
                               (recorders[4], icp_entry, cuda_icp)):
        for (name, shape), (args, kwargs) in sorted(rec.inputs.items()):
            key = (name, shape)
            n_launch = full_key.get(key, by_key.get(key, sum(
                c.get(key, 0) for c in (cli_key, global_key, p2l_key))))
            good, entry = entry_fn(mod, shape, n_launch, args, kwargs)
            ok = ok and good
            entries.append(entry)
    if not ok:
        fail("see the messages above")

    print(json.dumps({"kernels": entries}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
