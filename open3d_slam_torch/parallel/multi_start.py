"""Multi-start batched global localization.

Port of ``open3d_slam_tpu.parallel.multi_start`` on its kernel route.  The
reference's localization mode needs a user-provided initial pose
(``SlamMapInitializer.cpp:51-78``); here ~1024 pose hypotheses are swept in
one batched ICP program instead: stratified (x, y, yaw) seeds over the map
extent -> short coarse point-to-plane ICP on a subsampled scan -> ranking by
a tight-distance score -> point-to-point pull-in of the best -> tight
point-to-plane refinement -> one full-scan registration of the winner.

The point-to-plane stages run through kernel K4 in its shared-target layout
(the map is swept once per kernel call for the whole hypothesis batch); the
point-to-point stage finds the correspondences of all its hypotheses in one
K3 launch per iteration.  The JAX package's chunked-``vmap`` route (its CPU
path) is not ported.

``jax.random`` draws cannot be reproduced in torch, so the three random
downsamples take their uniform scores from ``draw_scores(key, n)``, keyed by
the JAX package's ``PRNGKey`` numbers 11, 13 and 12: normal runs use a
seeded ``torch.Generator`` per key, the tests JAX's own draws.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from open3d_slam_torch.ops import cuda_icp, hashgrid, nn_layout, normals as normals_ops, voxel
from open3d_slam_torch.ops import registration as reg_ops
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.config import SlamParameters
from open3d_slam_torch.utils.device import to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud

STAGES = ("coarse", "rank", "mid", "refine", "final")


def make_pose_hypotheses(map_points: np.ndarray, map_mask: np.ndarray,
                         num_hypotheses: int, z: float = 0.0) -> np.ndarray:
    """Stratified (x, y, yaw) grid over the map's bounding box -> (H, 4, 4)."""
    pts = map_points[map_mask]
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    n_yaw = 8
    n_xy = max(1, int(np.sqrt(num_hypotheses / n_yaw)))
    xs = np.linspace(lo[0], hi[0], n_xy)
    ys = np.linspace(lo[1], hi[1], n_xy)
    yaws = np.linspace(0, 2 * np.pi, n_yaw, endpoint=False)
    T = []
    for x in xs:
        for y in ys:
            for yaw in yaws:
                c, s = np.cos(yaw), np.sin(yaw)
                M = np.eye(4, dtype=np.float32)
                M[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                M[:3, 3] = [x, y, z]
                T.append(M)
    T = np.stack(T)
    if len(T) < num_hypotheses:
        T = np.tile(T, (int(np.ceil(num_hypotheses / len(T))), 1, 1))
    return T[:num_hypotheses]


class SeededScores:
    """Uniform downsample scores from a ``torch.Generator`` seeded with the
    key: the same key gives the same draws on every call."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __call__(self, key: int, n: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        return torch.rand(n, generator=g, device=self.device)


class _StageClock:
    """Wall ms of each funnel stage into ``out`` (when given), each stage
    ended by a device synchronisation; nothing at all without ``out``."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out, self.device = out, device
        self.t0 = time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = (now - self.t0) * 1e3
        self.t0 = now


def batched_localize(scan_small: PointCloud, scan_mid: PointCloud,
                     scan_rank: PointCloud, scan_full: PointCloud,
                     coarse_grid: hashgrid.HashGrid, mid_grid: hashgrid.HashGrid,
                     grid: hashgrid.HashGrid, inits: torch.Tensor,
                     coarse_corr_dist, mid_corr_dist, max_corr_dist,
                     coarse_iters: int = 10, mid_iters: int = 12,
                     refine_iters: int = 12, top_k: int = 64,
                     profile: Optional[dict] = None):
    """The multi-resolution funnel (``_batched_localize`` of the JAX
    package, its TPU route):

      1. coarse point-to-plane sweep of ALL hypotheses at about half the
         seed spacing, subsampled scan against a coarse-voxel map (K4);
      2. rank by the tight-distance score fitness - rmse at the coarse
         poses: the batched loop with ``max_iterations=0`` is
         ``evaluate_registration`` for the whole batch in one sweep (K4);
      3. point-to-point pull-in of the ``top_k`` (its translation basin is
         wider than point-to-plane's on plane-dominated scenes), 1024-point
         subsample against a mid-voxel map (K3);
      4. tight batched point-to-plane refinement; winner by fitness - rmse
         (K4);
      5. one full-scan point-to-plane registration of the winner at full map
         resolution (K4).

    ``jax.lax.top_k`` puts the lower index first among equal scores: a
    stable descending sort does the same; ``torch.argmax`` takes the first
    maximum as ``jnp.argmax`` does.  With ``profile`` (a dict) each stage's
    synchronised wall ms is stored under its name.  Returns (T (4, 4),
    fitness) as device tensors."""
    clock = _StageClock(profile, inits.device)
    coarse = reg_ops.batched_icp_point_to_plane(
        scan_small, coarse_grid, inits, coarse_corr_dist,
        max_iterations=coarse_iters)
    clock.mark("coarse")
    # The map's K4 target arrays and sweep layout, and the rank scan's
    # order, serve three stages.
    prepared = cuda_icp.prepare_target(grid.points_sorted, grid.normals_sorted,
                                       grid.hashes_sorted != hashgrid.INT32_MAX)
    rank_order = nn_layout.query_order(scan_rank.points, scan_rank.mask)
    tight = reg_ops.batched_icp_point_to_plane(
        scan_rank, grid, coarse.transformation, max_corr_dist, max_iterations=0,
        prepared=prepared, source_order=rank_order)
    clock.mark("rank")
    score = tight.fitness - tight.inlier_rmse
    best_idx = torch.sort(score, descending=True, stable=True).indices[:top_k]
    mid = reg_ops.batched_icp_point_to_point(
        scan_mid, mid_grid, coarse.transformation[best_idx], mid_corr_dist,
        max_iterations=mid_iters)
    clock.mark("mid")
    refined = reg_ops.batched_icp_point_to_plane(
        scan_rank, grid, mid.transformation, max_corr_dist,
        max_iterations=refine_iters, prepared=prepared, source_order=rank_order)
    clock.mark("refine")
    win = torch.argmax(refined.fitness - refined.inlier_rmse)
    final = reg_ops.icp_point_to_plane(
        scan_full, grid, refined.transformation[win], max_corr_dist,
        max_iterations=10, prepared=prepared)
    clock.mark("final")
    return final.transformation, final.fitness


def global_localize(scan: PointCloud, map_cloud: PointCloud,
                    params: SlamParameters, num_hypotheses: int = 1024,
                    coarse_scan_points: int = 512,
                    draw_scores: Optional[Callable[[int, int], torch.Tensor]] = None,
                    profile: Optional[dict] = None) -> Tuple[np.ndarray, float]:
    """Localize ``scan`` in ``map_cloud`` with no initial pose.  Returns
    (T (4, 4) float64, fitness)."""
    dev = scan.device
    draw_scores = draw_scores or SeededScores(dev)
    sp = params.mapper.scan_processing
    icp = params.mapper.scan_matcher.icp
    scan_v = voxel.voxel_downsample(scan, max(sp.voxel_size, 1e-3))

    def subsample(n: int, key: int) -> PointCloud:
        kept = voxel.random_downsample(scan_v, n, draw_scores(key, scan_v.capacity))
        return pclib.compact_to(kept, pclib.padded_capacity(n))

    scan_small = subsample(coarse_scan_points, 11)
    scan_mid = subsample(min(1024, scan_v.capacity), 13)
    scan_rank = subsample(min(2048, scan_v.capacity), 12)
    m = map_cloud
    if m.normals is None:
        m = normals_ops.estimate_normals(m, radius=icp.max_distance_knn,
                                         max_nn=icp.knn)
    grid = hashgrid.build(m, cell_size=icp.max_correspondence_distance)
    pts_all, mask_np = to_host(m.points, m.mask)
    mask_np = mask_np.astype(bool)
    pts_np = pts_all.astype(np.float32)[mask_np]
    inits = make_pose_hypotheses(pts_all.astype(np.float32), mask_np,
                                 num_hypotheses, z=float(pts_np[:, 2].mean() + 1.0))
    # Coarse basin: about half the (x, y) seed spacing.
    extent = float(max(np.ptp(pts_np[:, 0]), np.ptp(pts_np[:, 1])))
    n_xy = max(1, int(np.sqrt(num_hypotheses / 8)))
    spacing = extent / max(n_xy - 1, 1)
    coarse_corr = max(icp.max_correspondence_distance, 0.75 * spacing)
    mid_corr = max(2.0 * icp.max_correspondence_distance, 2.0)
    # Coarser maps for the wide-basin stages: the kernel's cost scales with
    # the map's rows, and the final registration runs at full resolution.
    coarse_map = normals_ops.estimate_normals(
        voxel.voxel_downsample(m, max(0.5, float(coarse_corr) / 4.0),
                               out_capacity=max(m.capacity // 4, 1024)),
        radius=icp.max_distance_knn, max_nn=icp.knn)
    coarse_grid = hashgrid.build(coarse_map, cell_size=coarse_corr)
    mid_map = voxel.voxel_downsample(m, max(0.4, float(mid_corr) / 5.0),
                                     out_capacity=max(m.capacity // 2, 2048))
    mid_grid = hashgrid.build(mid_map, cell_size=mid_corr)
    T, fitness = batched_localize(
        scan_small, scan_mid, scan_rank, scan_v, coarse_grid, mid_grid, grid,
        to_device(inits, dev), coarse_corr, mid_corr,
        icp.max_correspondence_distance, top_k=min(64, int(inits.shape[0])),
        profile=profile)
    T, fitness = to_host(T, fitness)
    return np.asarray(T, np.float64), float(fitness)
