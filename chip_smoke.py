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
  5a. replays them once more with the dense map on as well
     (``mapper.is_build_dense_map`` with the file's own dense map builder:
     0.05 m voxels, a 15 m crop, a carve every 10 scans, 524288 voxels a
     submap), and checks that the poses are bit-equal to step 5's (the dense
     map is write-only for tracking), that the closure moved dense stores,
     that carving removed voxels and that the dense stage made no host sync
     (the counted pulls equal step 5's, and torch's sync debug mode flags
     nothing in it); prints the dense stage's p50 and p99 ms per scan, the
     voxels per submap and the store's bytes, then writes the dense submaps
     as PCDs and reads them back equal to ``get_dense_map_cloud``;
  5b. runs the first scans of step 4 through ``AsyncSlamDriver`` (ingest on
     this thread, the pipeline and every kernel launch on its worker) and
     checks the poses against step 4's sequential poses;
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
  8a. the scale-out layer (``parallel/``) in a 1-rank NCCL group (the card
     is one H100, and NCCL refuses two ranks on one device): the JAX
     package's ``bench_batched_icp`` batch (128 scan pairs, 1024-point
     sources on 2048-point targets, a target per element) sharded over the
     data axis, easy and hard, its registrations/s and its results against
     the unsharded call; block-sharded point-to-plane and GICP at the
     scan-to-map shapes (16384 x 65536) against the calls without a group;
     the pose-graph refinement stage; and ``batch_map_sequences`` against
     each sequence's own replay (the checks run after the counts are read);
  9. holds each kernel against its plain PyTorch version on the card, on the
     inputs the runs last gave it at each of its shapes, and times both
     next to the least time the card could take (the bound); for K1 and K4
     also the device time of each of a call's launches (``torch.profiler``),
     for K2's prepass also the matmul + topk chain it replaced, and for the
     sweeps the share of pairs their skip leaves; K3 both gated (the
     callers' entry, held by their verdict) and ungated (bit-equal), with
     ``torch.cdist(...).argmin(1)`` timed beside it;
  10. prints a ``kernels`` JSON line, the card line, and last the device
      JSON.

Steps 5a, 5b, 6 to 8 and 8a each set every launch count to 0 just before and
read it just after, and fail if a kernel of their path did not run.

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
import warnings

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
# Step 8a: bench.py's bench_batched_icp (batch, source, target points,
# voxel, correspondence distance, iterations easy / hard) and the
# scan-to-map shapes of __graft_entry__.py's stage 5.
PAR_BATCH, PAR_SRC, PAR_TGT = 128, 1024, 2048
PAR_VOXEL, PAR_CORR = 0.3, 0.5
PAR_ITERS = {"easy": 15, "hard": 30}
PAR_REPEATS = 3
BLOCK_SCAN, BLOCK_MAP, BLOCK_VALID = 16384, 65536, 40000
BLOCK_ITERS = 10


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
    launches, by kernel name (without its namespaces and arguments), from
    ``torch.profiler`` over ``reps`` calls after one warm-up call."""
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

    out = {}
    for e in prof.key_averages():     # kernels whose short names match add up
        if e.device_type == cuda:
            out[name(e.key)] = round(out.get(name(e.key), 0.0)
                                     + e.self_device_time_total / reps, 2)
    return out


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
    """K3 at one shape the replays recorded: ``nn_argmin_within`` (the
    callers' gated entry) against the full plain sweep, by the callers'
    verdict (``hashgrid.query_nearest``: the winner's exact d2 within r, a
    valid target) and bit for bit on (index, e) wherever it holds; the
    ungated ``nn_argmin`` bit-equal to its plain version on the same inputs,
    flattened; ``torch.cdist(...).argmin(1)`` timed as the library
    yardstick (not the same function: it rounds otherwise)."""
    import torch
    from open3d_slam_torch.ops import hashgrid, nn_layout
    bound = inspect.signature(cuda_knn.nn_argmin_within).bind(*args, **kwargs)
    queries, qmask, layout, r = bound.args
    b, m, n = shape
    got_i, got_e = cuda_knn.nn_argmin_within(*bound.args)
    want_i, want_e = cuda_knn.nn_argmin_within_plain(*bound.args)
    points, valid = cuda_knn.layout_targets(layout.target)
    r2 = torch.tensor(float(r), dtype=torch.float32, device=queries.device) ** 2
    (got_f, got_d2), (want_f, _) = (hashgrid.gate(points, valid, queries, i, e, r)
                                    for i, e in ((got_i, got_e), (want_i, want_e)))
    rest = ~want_f
    gated_ok = (torch.equal(got_f, want_f) and torch.equal(got_i[want_f], want_i[want_f])
                and torch.equal(got_e[want_f].view(torch.int32),
                                want_e[want_f].view(torch.int32))
                and bool((((got_e[rest] == float("inf")) & (got_i[rest] == 0))
                          | (got_d2[rest] > r2)).all()))
    q = queries.reshape(-1, 3)
    t_t = points.t().contiguous()
    t2 = torch.where(valid, cuda_knn.squared_norms(points), float("inf"))
    ug_i, ug_e = cuda_knn.nn_argmin(q, t_t, t2)
    pl_i, pl_e = cuda_knn.nn_argmin_plain(*cuda_knn.knn_inputs(q, t_t, t2))
    ungated_ok = torch.equal(ug_i, pl_i) and torch.equal(ug_e.view(torch.int32),
                                                          pl_e.view(torch.int32))
    torch.cuda.synchronize()
    fin = torch.isfinite(pl_e)
    err = max(float((got_e[want_f] - want_e[want_f]).abs().max()) if bool(want_f.any()) else 0.0,
              float((ug_e[fin] - pl_e[fin]).abs().max()) if bool(fin.any()) else 0.0)
    ms = time_ms(lambda: cuda_knn.nn_argmin_within(*bound.args), 20)
    ungated_ms = time_ms(lambda: cuda_knn.nn_argmin(q, t_t, t2), 20)
    plain = time_ms(lambda: cuda_knn.nn_argmin_within_plain(*bound.args), 3)
    t_valid = points[valid].contiguous()
    lib_idx = torch.nonzero(valid)[:, 0][torch.cdist(
        q, t_valid, compute_mode="use_mm_for_euclid_dist").argmin(1)]
    agree = float((lib_idx == pl_i.long()).float().mean())
    del lib_idx
    library = time_ms(lambda: torch.cdist(q, t_valid, compute_mode="use_mm_for_euclid_dist")
                      .argmin(1), 3)
    # 9 flops a pair the skip leaves at 64 x 64 (the 3-term dot, |q|^2 +
    # |t|^2, the 2x, the subtraction and the compare).  Each input read once
    # (queries, mask, order, staged targets, tile boxes), each output written
    # once (index, e).
    mask_f = (torch.ones((m, 1), device=q.device) if qmask is None
              else qmask.reshape(-1, m, 1).float())
    need = nn_layout.tile_need(queries, mask_f, layout, r2.reshape(1, 1), margin=True)
    pairs = int(need.sum().item()) * nn_layout.GROUP * nn_layout.TILE
    n_bytes = 12 * b * m + b * m + 4 * m + layout.target.pts.numel() * 4 + \
        layout.target.boxes.numel() * 4 + 8 * b * m
    b_ms, b_by = bound_ms(n_bytes, 9.0 * pairs)
    all_ms, all_by = bound_ms(n_bytes, 9.0 * b * m * n)
    found_share = float(want_f.float().mean())
    print(f"K3 nn_argmin_within {b}x{m}x{n} (r {float(r):g} m): verdict equal "
          f"{torch.equal(got_f, want_f)} ({found_share:.4f} found), indices and e equal on "
          f"found {gated_ok}; ungated nn_argmin {b * m}x{n} bit-equal {ungated_ok}; max abs "
          f"err {err:.3e} (exact required); {ms:.4f} ms gated, {ungated_ms:.4f} ms ungated, "
          f"plain {plain:.4f} ms, cdist + argmin {library:.4f} ms (indices agree "
          f"{agree:.4f}); bound {b_ms:.5f} ms ({b_by}; swept {pairs} of {b * m * n} pairs, "
          f"{100.0 * pairs / (b * m * n):.2f}%), all-pairs bound {all_ms:.5f} ms ({all_by})")
    return gated_ok and ungated_ok, {
        "name": f"nn_argmin[{b}x{m}x{n}]", "route": "cuda",
        "source": "open3d_slam_torch/csrc/knn.cu",
        "replaces": "open3d_slam_tpu/ops/pallas_knn.py:58",
        "launches": n_launch, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library}


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


def poses_sha1(poses) -> str:
    """The first 16 hex digits of the sha1 of 4x4 poses as float64: two runs
    with equal digests gave bit-equal poses."""
    import numpy as np
    return hashlib.sha1(np.stack(poses).astype(np.float64).tobytes()).hexdigest()[:16]


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
    errs, got = [], None
    if ok:
        got = np.load(out)["poses"]
        ok = len(got) == LOC_SCANS
        errs = [pose_error(a, b) for a, b in zip(poses[:LOC_SCANS], got)]
    worst_t = max((e[0] for e in errs), default=float("inf"))
    worst_r = max((e[1] for e in errs), default=float("inf"))
    print(f"CLI localization: rc {rc}, {len(errs)} of {LOC_SCANS} poses in "
          f"{wall:.2f} s (map load and normals included), poses sha1 "
          f"{poses_sha1(got) if ok else None}; largest gap to the "
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
    times, errs, found = [], [], []
    for seed in GLOBAL_SEEDS:
        dt, T, T_true, fit = localize(seed)
        times.append(dt)
        found.append(T)
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
          f"{p50 * 1e3:.2f} ms, {GLOBAL_HYPOTHESES / p50:.1f} hypotheses/s, poses sha1 "
          f"{poses_sha1(found)}; stage "
          f"ms (one synchronised run) {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
          f"launches {json.dumps(shape_counts(counts))}", flush=True)
    missing = missing_kernels(cuda_build, counts,
                              ("p2l_normal_eq", "nn_argmin_within", "kth_neighbor_d2_within",
                               "radius_moments_at"))
    if missing:
        print(f"global localization never launched {missing}", file=sys.stderr)
    return good == len(errs) and not missing, counts


def dense_replay(full, seq, scans, full_poses, full_syncs, here, cuda_build, devmod,
                 evaluation, pcd, pclib, SlamWrapper):
    """Step 5a: step 5's replay with the dense map on.  Returns (ok, the
    launch counts)."""
    import copy
    import numpy as np
    import torch
    from open3d_slam_torch.ops import dense_map
    params = copy.deepcopy(full)
    params.mapper.is_build_dense_map = True
    b, cap = params.mapper.dense_map_builder, params.capacities.dense_submap_voxels
    print(f"step 5a: dense map on, voxel {b.map_voxel_size} m, crop "
          f"{b.cropper.cropping_max_radius} m, carve every "
          f"{b.carving.carve_space_every_n_scans} scans, {cap} voxels a submap "
          f"({dense_map.BYTES_PER_VOXEL} bytes a voxel: "
          f"{dense_map.BYTES_PER_VOXEL * cap} bytes a submap, "
          f"{dense_map.BYTES_PER_VOXEL * cap * params.capacities.max_submaps} at "
          f"{params.capacities.max_submaps} submaps)", flush=True)
    slam = SlamWrapper(params, device="cuda")
    slam.warmup(scans=seq.scans[:N_SKIP], timestamps=seq.timestamps[:N_SKIP])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probe = DenseStageProbe(slam, dense_map)
    # The detector's control: a pull to the host must be reported.
    _, control = probe.syncs_in(lambda: torch.ones(1, device="cuda").sum().item())
    if not control:
        fail("torch's sync debug mode did not report a .item() pull")
    probe.install()
    try:
        per_scan_ms, wall_s, counts, syncs = replay(slam, scans, cuda_build, devmod)
    finally:
        probe.remove_probes()
    peak = torch.cuda.max_memory_allocated()
    poses, ate, _ = check_trajectory(slam, seq, len(scans), evaluation)
    health = slam.get_health()
    n = len(scans)
    voxels = [int(v) for v in devmod.to_host(*[s.dense_map.num_voxels()
                                                for s in slam.submaps.submaps])]
    removed = int(devmod.to_host(probe.removed)[0][()])
    host = np.percentile(probe.host_ms, [50, 99])
    dev_ms = np.array(probe.device_ms())
    dev = np.percentile(dev_ms, [50, 99])
    carved = np.array(probe.carved)
    digest, want = poses_sha1(poses), poses_sha1(full_poses)
    print(f"dense replay: {n} scans, per-scan p50 {np.median(per_scan_ms):.2f} ms, "
          f"host syncs {syncs} ({full_syncs} in step 5), poses sha1 {digest} "
          f"(step 5: {want}), ATE rmse {ate.rmse:.4f} m, closures "
          f"{health['n_loop_closures_accepted']}, optimisations applied "
          f"{health['n_optimizations_applied']}, dense stores moved {probe.moves}")
    print(f"dense stage ({len(probe.host_ms)} calls): host ms p50 {host[0]:.3f} p99 "
          f"{host[1]:.3f}; device ms between its events p50 {dev[0]:.3f} p99 "
          f"{dev[1]:.3f} (scans without a carve p50 {np.median(dev_ms[~carved]):.3f}, "
          f"with one p50 {np.median(dev_ms[carved]):.3f}); synchronising operations "
          f"in it {len(probe.sync_warnings)} (torch's sync debug mode; it reported "
          f"{len(control)} for one .item()); carves "
          f"{probe.carves} removed {removed} voxels; dense voxels per submap "
          f"{voxels}; peak device memory {peak} bytes; launches "
          f"{json.dumps(shape_counts(counts))}", flush=True)
    ok = True
    if digest != want or syncs != full_syncs or probe.sync_warnings:
        print(f"the dense stage moved the poses or synchronised: "
              f"{probe.sync_warnings[:3]}", file=sys.stderr)
        ok = False
    if health["n_optimizations_applied"] < 1 or probe.moves < 1 or removed <= 0 \
            or len(probe.host_ms) != n or voxels[0] <= 0:
        print("dense replay: no closure moved a dense store, carving removed "
              "nothing, or a submap's dense map is empty", file=sys.stderr)
        ok = False
    folder = os.path.join(here, "o3d_slam_out", "chip_smoke_dense")
    os.makedirs(folder, exist_ok=True)
    slam.dump_submaps("dense_submap", dense=True, folder=folder)
    back = [pcd.read_pcd(os.path.join(folder, f"dense_submap_{i}.pcd"))
            for i in range(slam.submaps.get_num_submaps())]
    want_cloud = slam.get_dense_map_cloud()
    # A PCD packs colours 8 bits a channel.
    want_cloud["colors"] = (np.clip(want_cloud["colors"] * 255.0, 0, 255)
                            .astype(np.uint32).astype(np.float32) / 255.0)
    same = all(np.array_equal(np.concatenate([c[k] for c in back if len(c["points"])]),
                              want_cloud[k]) for k in ("points", "normals", "colors"))
    print(f"dense PCDs: {len(back)} files, {sum(len(c['points']) for c in back)} "
          f"points, equal to get_dense_map_cloud {same}", flush=True)
    missing = missing_kernels(cuda_build, counts, ("gicp_normal_eq", "kth_neighbor_d2_within",
                                                   "radius_moments_at", "nn_argmin_within"))
    if missing or not same:
        print(f"dense replay never launched {missing}, or its PCDs differ",
              file=sys.stderr)
        ok = False
    return ok, counts


def async_replay(params, scans, seq_poses, cuda_build, AsyncSlamDriver, SlamWrapper):
    """Step 5b: step 4's first scans through ``AsyncSlamDriver``; its worker
    thread launches every kernel.  Returns (ok, the launch counts)."""
    import numpy as np
    slam = SlamWrapper(params, device="cuda")
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    with AsyncSlamDriver(slam) as driver:
        for points, ts in scans[:N_DETERMINISM]:
            deadline = time.monotonic() + 120.0
            while driver.is_backpressured():
                if time.monotonic() > deadline:
                    fail("the online driver stopped draining its buffers")
                time.sleep(0.001)
            driver.add_range_scan(points, ts)
    wall = time.perf_counter() - t0
    counts = dict(cuda_build.launches)
    _, poses = slam.get_trajectory()
    dev = max((float(np.abs(a - b).max()) for a, b in zip(poses, seq_poses)),
              default=float("inf"))
    equal = len(poses) == len(seq_poses) and all(
        np.array_equal(a, b) for a, b in zip(poses, seq_poses))
    print(f"online driver: {len(poses)} of {N_DETERMINISM} scans in {wall:.2f} s; "
          f"against step 4's sequential poses max abs difference {dev:.3e} (tol "
          f"1e-6), bit-equal {equal}; launches {json.dumps(shape_counts(counts))}",
          flush=True)
    missing = missing_kernels(cuda_build, counts, ("gicp_normal_eq", "kth_neighbor_d2_within",
                                                   "radius_moments_at"))
    if missing:
        print(f"the online driver never launched {missing}", file=sys.stderr)
    return len(poses) == N_DETERMINISM and dev <= 1e-6 and not missing, counts


def bench_batch(datasets, pclib, voxel, normals_ops, hashgrid):
    """bench.py's ``bench_batched_icp`` inputs on the card: 128 scans of a
    SyntheticWorld (extent 30 m; 60000/40000/30000 ground/wall/pillar
    points) from a radius-15 m circle, targets voxelized at 0.3 m with
    normals (r 1 m, k 10) in 0.5 m grids, sources 1024 of each scan's points
    moved by (0.15, -0.1, 0.02) m; easy inits the identity, hard ones
    +-0.5 m and +-10 degrees.  Returns (sources, grids, {name: inits})."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    world = datasets.SyntheticWorld(datasets.SyntheticWorldConfig(
        extent=30.0, n_ground=60000, n_walls=40000, n_pillars=30000))
    poses = datasets.circle_trajectory(PAR_BATCH, radius=15.0)
    srcs = np.zeros((PAR_BATCH, PAR_SRC, 3), np.float32)
    tgts = np.zeros((PAR_BATCH, PAR_TGT, 3), np.float32)
    for b, T in enumerate(poses):
        scan = world.render_scan(T, max_range=25.0, n_points=PAR_TGT)
        tgts[b] = scan[:PAR_TGT]
        srcs[b] = scan[rng.choice(PAR_TGT, PAR_SRC, replace=False)] + np.array(
            [0.15, -0.1, 0.02], np.float32)
    dev = torch.device("cuda")
    prepped = [normals_ops.estimate_normals(voxel.voxel_downsample(
        pclib.from_numpy(t, capacity=PAR_TGT, device=dev), PAR_VOXEL), 1.0, max_nn=10)
        for t in tgts]
    grids = hashgrid.build_batched(pclib.PointCloud(
        points=torch.stack([p.points for p in prepped]),
        mask=torch.stack([p.mask for p in prepped]),
        normals=torch.stack([p.normals for p in prepped])), PAR_CORR)
    sources = pclib.PointCloud(points=torch.from_numpy(srcs).to(dev),
                               mask=torch.ones((PAR_BATCH, PAR_SRC), dtype=torch.bool,
                                               device=dev))
    hard = np.tile(np.eye(4, dtype=np.float32), (PAR_BATCH, 1, 1))
    axes = rng.normal(size=(PAR_BATCH, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angs = rng.uniform(-np.deg2rad(10.0), np.deg2rad(10.0), PAR_BATCH)
    for b in range(PAR_BATCH):
        K = np.array([[0, -axes[b, 2], axes[b, 1]], [axes[b, 2], 0, -axes[b, 0]],
                      [-axes[b, 1], axes[b, 0], 0]])
        hard[b, :3, :3] = np.eye(3) + np.sin(angs[b]) * K + (1 - np.cos(angs[b])) * (K @ K)
        hard[b, :3, 3] = rng.uniform(-0.5, 0.5, 3)
    inits = {"easy": torch.eye(4, device=dev).repeat(PAR_BATCH, 1, 1),
             "hard": torch.from_numpy(hard).to(dev)}
    return sources, grids, inits


def same_result(a, b) -> bool:
    """Two ``RegistrationResult``s bit-equal in every field."""
    import torch
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in
               ("transformation", "fitness", "inlier_rmse", "num_iterations"))


def scale_out(cuda_build, name_power, datasets, pclib, recorders):
    """Step 8a: the scale-out layer in a 1-rank NCCL group.  The launch
    counts are set to 0 just before the sharded path's runs (its inputs'
    preparation included) and read just after them; the recorders are then
    removed, and the checks (the unsharded calls, the batch's first half
    alone, the profiler's runs, each sequence's own replay) run after, so
    they add to no count and record no inputs.  Returns (ok, the counts)."""
    import statistics
    import numpy as np
    import torch
    import torch.distributed as dist
    from open3d_slam_torch.models.slam_wrapper import SlamWrapper
    from open3d_slam_torch.ops import hashgrid, normals as normals_ops, voxel
    from open3d_slam_torch.ops import registration as reg_ops
    from open3d_slam_torch.parallel import mesh as mesh_lib, multihost, sharded_icp

    t_step = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, device="cuda",
                         timeout_s=300.0)
    ok = dist.get_backend() == "nccl"
    mesh = multihost.global_mesh(1)
    print(f"step 8a: {dist.get_backend()} group of {dist.get_world_size()} on "
          f"{mesh_lib.collective_device()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}",
          flush=True)

    # The sharded path, counted.
    cuda_build.launches.clear()
    # The data-sharded batch at bench_batched_icp's width.
    t0 = time.perf_counter()
    sources, grids, inits = bench_batch(datasets, pclib, voxel, normals_ops, hashgrid)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    runs, results, ms = {}, {}, {}
    for name, iters in PAR_ITERS.items():
        runs[name] = (lambda name=name, iters=iters: sharded_icp.batched_icp_p2l(
            sources, grids, inits[name], PAR_CORR, max_iterations=iters, mesh=mesh))
        results[name] = runs[name]()
        ms[name] = []
        for _ in range(PAR_REPEATS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            results[name] = runs[name]()
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    # Block-sharded point-to-plane and GICP at the scan-to-map shapes.
    dev = torch.device("cuda")
    rng = np.random.default_rng(55)
    base = rng.uniform(-30, 30, size=(BLOCK_VALID, 3)).astype(np.float32)
    base[:, 2] = np.abs(base[:, 2]) * 0.1
    src = base[rng.choice(BLOCK_VALID, BLOCK_SCAN, replace=False)] + np.array(
        [0.2, -0.1, 0.0], np.float32)
    map_pc = normals_ops.estimate_normals(
        pclib.from_numpy(base, capacity=BLOCK_MAP, device=dev), 1.2, max_nn=10)
    grid = hashgrid.build(map_pc, 1.0)
    scan = normals_ops.estimate_normals(pclib.from_numpy(src, capacity=BLOCK_SCAN, device=dev),
                                        1.2, max_nn=10)
    eye = torch.eye(4, device=dev)
    n_block = mesh.size(1)
    block_p2l = sharded_icp.make_block_sharded_icp(mesh, 1.0, max_iterations=BLOCK_ITERS)(
        sharded_icp.split_points_for_blocks(scan, n_block), grid, eye)
    covs = normals_ops.covariances_from_normals(map_pc)[grid.order.long()]
    scan_covs = normals_ops.covariances_from_normals(scan)
    block_gicp = sharded_icp.make_block_sharded_gicp(mesh, 1.0, max_iterations=BLOCK_ITERS)(
        sharded_icp.split_points_for_blocks(scan, n_block),
        sharded_icp.split_points_for_blocks(scan_covs, n_block), grid, covs, eye)
    # The pose-graph and batch-map stages.
    err = multihost.pose_graph_refinement_stage(mesh)
    summary = multihost.batch_map_stage()
    seqs, params = multihost.batch_map_inputs(2, 6, refine_every_scan=True)
    trajs = multihost.batch_map_sequences(seqs, params)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    path_s = time.perf_counter() - t_step
    for rec in recorders:
        rec.remove()

    # The checks, uncounted.
    print(f"batched p2l inputs: {PAR_BATCH} pairs of {PAR_SRC} x {PAR_TGT} points, "
          f"{int(grids.hashes_sorted.ne(hashgrid.INT32_MAX).sum())} valid targets after the "
          f"{PAR_VOXEL} m voxels, prepared in {prep_s:.2f} s", flush=True)
    for name, iters in PAR_ITERS.items():
        res = results[name]
        want = reg_ops.batched_icp_point_to_plane(sources, grids, inits[name], PAR_CORR,
                                                  max_iterations=iters)
        equal = same_result(res, want)
        # The first half alone, as rank 0 of a (2, 1) mesh runs it: the
        # sweep's split count (nn_layout.plan_splits) depends on the batch.
        half = PAR_BATCH // 2
        alone = reg_ops.batched_icp_point_to_plane(
            *mesh_lib.map_tensors(lambda x: x[:half], (sources, grids, inits[name])),
            PAR_CORR, max_iterations=iters)
        half_equal = same_result(alone, res[:half])
        p50 = statistics.median(ms[name])
        # Device time of one run, by kernel (torch.profiler): the rest of
        # the batch's wall time the card idles.
        busy = launch_us(runs[name], reps=1)
        busy_ms = sum(busy.values()) / 1e3
        top = dict(sorted(busy.items(), key=lambda kv: -kv[1])[:4])
        print(f"data-sharded batched p2l {name} ({iters} iterations): "
              f"{PAR_BATCH / (p50 / 1e3):.1f} registrations/s (median of {PAR_REPEATS}: "
              f"{p50:.3f} ms a batch; runs {[round(x, 3) for x in ms[name]]}), mean fitness "
              f"{float(res.fitness.mean()):.4f}, mean iterations "
              f"{float(res.num_iterations.float().mean()):.2f}; bit-equal to the "
              f"unsharded call {equal}, its first {half} alone bit-equal to theirs in the "
              f"batch {half_equal}; device busy {busy_ms:.3f} ms of the batch (idle share "
              f"{1.0 - busy_ms / p50:.4f}), top kernels (us) {json.dumps(top)}; {name_power}",
              flush=True)
        ok = ok and equal and half_equal and float(res.fitness.mean()) > 0.5
    equal = same_result(block_p2l, reg_ops.icp_point_to_plane(
        scan, grid, eye, 1.0, max_iterations=BLOCK_ITERS))
    print(f"block-sharded p2l {BLOCK_SCAN} x {BLOCK_MAP} over {n_block} block: fitness "
          f"{float(block_p2l.fitness):.4f}, {int(block_p2l.num_iterations)} iterations, "
          f"bit-equal to icp_point_to_plane on the whole scan {equal}", flush=True)
    ok = ok and equal
    equal = same_result(block_gicp, reg_ops.icp_generalized(
        scan, scan_covs, grid, covs, eye, 1.0, max_iterations=BLOCK_ITERS))
    print(f"block-sharded GICP {BLOCK_SCAN} x {BLOCK_MAP} over {n_block} block: fitness "
          f"{float(block_gicp.fitness):.4f}, {int(block_gicp.num_iterations)} iterations, "
          f"bit-equal to icp_generalized on the whole scan {equal}", flush=True)
    ok = ok and equal
    own = []
    for seq in seqs:
        slam = SlamWrapper(params, device="cuda")
        for points, ts in zip(seq.scans, seq.timestamps):
            slam.process_scan(points, ts)
        own.append(np.stack(slam.get_trajectory()[1]))
    equal = all(np.array_equal(t[:len(o)], o) and not t[len(o):].any()
                for t, o in zip(trajs, own))
    dist.destroy_process_group()
    print(f"pose-graph refinement: endpoint error {err:.5f} m (limit 0.05); batch map "
          f"{json.dumps(summary)}; batch_map_sequences with every scan refined: poses "
          f"{[len(o) for o in own]}, equal to each sequence's own replay {equal}; the "
          f"sharded path {path_s:.1f} s, step 8a {time.perf_counter() - t_step:.1f} s; "
          f"launches {json.dumps(shape_counts(counts))}", flush=True)
    ok = (ok and err < 0.05 and equal and summary["n_nonzero"] == summary["n_sequences"]
          and summary["max_start_err"] < 1e-3 and min(len(o) for o in own) > 1)
    missing = missing_kernels(cuda_build, counts, ("p2l_normal_eq", "gicp_normal_eq",
                                                   "kth_neighbor_d2_within",
                                                   "radius_moments_at"))
    if missing or not ok:
        print(f"step 8a failed a check, or never launched {missing}", file=sys.stderr)
    return ok and not missing, counts


def shape_counts(counts):
    return {f"{k}{list(s)}": c for (k, s), c in sorted(counts.items())}


class DenseStageProbe:
    """Stands in for a wrapper's ``submaps.insert_scan_dense_map`` during a
    replay: host ms and device ms (CUDA events, read after the replay) per
    call, the synchronising operations torch's sync debug mode reports in
    it, and, through ``dense_map.remove_keys`` and ``dense_map.transform``,
    the voxels carving removed (summed on the card) and the stores moved."""

    def __init__(self, slam, dense_map):
        import torch
        self.slam, self.dense_map = slam, dense_map
        self.insert = slam.submaps.insert_scan_dense_map
        self.remove, self.move = dense_map.remove_keys, dense_map.transform
        self.host_ms, self.events, self.sync_warnings, self.carved = [], [], [], []
        self.removed = torch.zeros((), dtype=torch.int64, device=slam.device)
        self.carves = self.moves = 0

    @staticmethod
    def syncs_in(fn):
        """(fn's result, the synchronising operations torch's sync debug
        mode reports while it runs)."""
        import torch
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # Each one warns "called a synchronizing CUDA operation"; the mode's
        # notice that it is a prototype does not.
        return out, [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)]

    def __call__(self, *args, **kwargs):
        import torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def timed():
            t = time.perf_counter()
            start.record()
            out = self.insert(*args, **kwargs)
            end.record()
            self.host_ms.append((time.perf_counter() - t) * 1e3)
            return out

        carves = self.carves
        out, syncs = self.syncs_in(timed)
        self.sync_warnings += syncs
        self.events.append((start, end))
        self.carved.append(self.carves > carves)
        return out

    def _remove(self, vm, *args, **kwargs):
        out = self.remove(vm, *args, **kwargs)
        self.removed += vm.num_voxels() - out.num_voxels()
        self.carves += 1
        return out

    def _move(self, *args, **kwargs):
        self.moves += 1
        return self.move(*args, **kwargs)

    def install(self):
        self.slam.submaps.insert_scan_dense_map = self
        self.dense_map.remove_keys, self.dense_map.transform = self._remove, self._move

    def remove_probes(self):
        self.dense_map.remove_keys, self.dense_map.transform = self.remove, self.move

    def device_ms(self):
        return [s.elapsed_time(e) for s, e in self.events]


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
        from open3d_slam_torch.models.async_driver import AsyncSlamDriver
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
                 Recorder(cuda_build, cuda_knn, "nn_argmin_within"),
                 Recorder(cuda_build, cuda_icp, "p2l_normal_eq")]
    for rec in recorders:
        rec.install()
    scans = list(zip(seq.scans, seq.timestamps))[N_SKIP:]
    n = len(scans)
    per_scan_ms, wall_s, by_key, syncs = replay(slam, scans, cuda_build, devmod)
    poses, ate, rpe = check_trajectory(slam, seq, n, evaluation)
    pose_digest = poses_sha1(poses)
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
    for name in ("nn_argmin_within", "p2l_normal_eq"):
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
          f"syncs {syncs} = {syncs / n:.2f} per scan, poses sha1 {poses_sha1(poses)}")
    print(f"ATE rmse {ate.rmse:.4f} m, mean {ate.mean:.4f} m, max {ate.max:.4f} m; "
          f"RPE trans {rpe.trans_rmse:.4f} m, rot {rpe.rot_rmse_deg:.4f} deg")
    print(f"health: {json.dumps(health)}")
    print(f"kernel launches in the full replay: {json.dumps(shape_counts(full_key))}",
          flush=True)
    full_poses, full_syncs = poses, syncs
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

    # 5a. The dense map on, with step 5's configuration and scans.
    good, dense_key = dense_replay(full, seq, scans, full_poses, full_syncs, here,
                                   cuda_build, devmod, evaluation, pcd, pclib, SlamWrapper)
    ok = ok and good

    # 5b. The online driver over step 4's first scans.
    good, async_key = async_replay(params, scans, seq_poses, cuda_build, AsyncSlamDriver,
                                   SlamWrapper)
    ok = ok and good

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

    # 8a. The scale-out layer in a 1-rank NCCL group.
    # It removes the recorders once its path has run.
    good, par_key = scale_out(cuda_build, name_power, datasets, pclib, recorders)
    ok = ok and good
    phases = (full_key, by_key, dense_key, async_key, cli_key, global_key, p2l_key, par_key)
    if set().union(*phases) != {key for rec in recorders for key in rec.inputs}:
        print("a launch key has no recorded inputs", file=sys.stderr)
        ok = False

    # 9. Each kernel against its plain version, at each of its shapes.  The
    # launches of a shape are those of the full replay, else the
    # closures-off replay's, else those of steps 6 to 8a together.
    entries = []
    for rec, entry_fn, mod in ((recorders[0], gicp_entry, cuda_gicp),
                               (recorders[1], kth_entry, cuda_normals),
                               (recorders[2], moments_entry, cuda_normals),
                               (recorders[3], knn_entry, cuda_knn),
                               (recorders[4], icp_entry, cuda_icp)):
        for (name, shape), (args, kwargs) in sorted(rec.inputs.items()):
            key = (name, shape)
            n_launch = full_key.get(key, by_key.get(key, sum(
                c.get(key, 0) for c in (cli_key, global_key, p2l_key, par_key))))
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
