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

What comes of the map alone (its hash grids, the coarse and mid maps, K4's
targets, K3's layout and the hypotheses) is built by ``prepare_map``; a
query's own part is ``localize``.  ``global_localize`` builds the products
for its one call; ``SlamMapInitializer.relocalize`` keeps them for the
loaded map.

Each localization is a tree of ``utils.timeutil.telemetry`` spans:
``relocalize.prep`` (the query's subsamples and, where they are built, the
map's products, with the ``relocalize.hypotheses`` count) then
``relocalize.coarse``, ``.rank``, ``.mid``, ``.refine`` and ``.final``,
under the caller's ``relocalize.query`` (``SlamMapInitializer.relocalize``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from open3d_slam_torch.ops import hashgrid, nn_layout, normals as normals_ops, voxel
from open3d_slam_torch.ops import registration as reg_ops
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.config import SlamParameters
from open3d_slam_torch.utils.device import to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry

STAGES = ("prep", "coarse", "rank", "mid", "refine", "final")


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


def _voxel_bound(n: int, span: np.ndarray, edge: float) -> int:
    """The most voxels of edge ``edge`` that ``n`` points whose bounding box
    spans ``span`` (3,) can fill, padded: no more than the points, nor than
    the cells their bounding box meets."""
    cells = float(np.prod(np.floor(span / edge) + 2.0))
    return pclib.padded_capacity(int(min(n, cells)))


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
    """Opens and closes the funnel's stage spans (``relocalize.<stage>``).
    With ``out`` (a dict) each stage is also bracketed by device
    synchronisations and its wall ms stored under its name; without it no
    synchronisation is added."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out, self.device = out, device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        with telemetry.span("relocalize." + name):
            if self.out is None:
                yield
                return
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.out[name] = (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass(frozen=True)
class MapProducts:
    """What the funnel needs of a map, made from the map alone
    (``prepare_map``): the same for every query against that map, and
    never written by the funnel."""

    grid: hashgrid.HashGrid          # the map (with normals) at max_corr
    target: tuple                    # K4's target of ``grid`` (rank, refine, final)
    coarse_grid: hashgrid.HashGrid   # the coarse-voxel map, with K2's normals
    coarse_target: tuple             # K4's target of ``coarse_grid`` (coarse)
    mid_grid: hashgrid.HashGrid      # the mid-voxel map
    mid_layout: nn_layout.TargetLayout   # K3's layout of ``mid_grid`` (mid)
    hypotheses: torch.Tensor         # (H, 4, 4) float32 on the map's device
    coarse_corr: float               # the stages' correspondence distances
    mid_corr: float
    max_corr: float


def map_settings(params: SlamParameters) -> tuple:
    """Every parameter value ``prepare_map`` reads: the ICP correspondence
    distance, and K2's neighbour count and radius."""
    icp = params.mapper.scan_matcher.icp
    return icp.max_correspondence_distance, icp.knn, icp.max_distance_knn


def prepare_map(map_cloud: PointCloud, params: SlamParameters,
                num_hypotheses: int) -> MapProducts:
    """The funnel's map-side products of ``map_cloud``: its normals (K2,
    where it has none) and hash grid at the correspondence distance, the
    coarse and mid maps and their grids, K4's targets and K3's layout, and
    ``num_hypotheses`` stratified poses over the map's extent.  One pull of
    the map to the host (its extent)."""
    max_corr, knn, radius = map_settings(params)
    m = map_cloud
    if m.normals is None:
        m = normals_ops.estimate_normals(m, radius=radius, max_nn=knn)
    grid = hashgrid.build(m, cell_size=max_corr)
    pts_all, mask_np = to_host(m.points, m.mask)
    mask_np = mask_np.astype(bool)
    pts_np = pts_all.astype(np.float32)[mask_np]
    inits = make_pose_hypotheses(pts_all.astype(np.float32), mask_np,
                                 num_hypotheses, z=float(pts_np[:, 2].mean() + 1.0))
    # Coarse basin: about half the (x, y) seed spacing.
    # Column by column: numpy reduces an (n, 3) array along its first
    # axis ~15 times slower.
    span = np.array([np.ptp(pts_np[:, k]) for k in range(3)])
    extent = float(max(span[0], span[1]))
    n_xy = max(1, int(np.sqrt(num_hypotheses / 8)))
    spacing = extent / max(n_xy - 1, 1)
    coarse_corr = max(max_corr, 0.75 * spacing)
    mid_corr = max(2.0 * max_corr, 2.0)
    # Coarser maps for the wide-basin stages: the kernel's cost scales with
    # the map's rows, and the final registration runs at full resolution.
    # Each holds every voxel its edge fills (a map held at a capacity of
    # its own size fills more than the JAX package's quarter or half).
    coarse_edge = max(0.5, float(coarse_corr) / 4.0)
    coarse_map = normals_ops.estimate_normals(
        voxel.voxel_downsample(m, coarse_edge, out_capacity=max(
            m.capacity // 4, 1024, _voxel_bound(len(pts_np), span, coarse_edge))),
        radius=radius, max_nn=knn)
    coarse_grid = hashgrid.build(coarse_map, cell_size=coarse_corr)
    mid_edge = max(0.4, float(mid_corr) / 5.0)
    mid_map = voxel.voxel_downsample(m, mid_edge, out_capacity=max(
        m.capacity // 2, 2048, _voxel_bound(len(pts_np), span, mid_edge)))
    mid_grid = hashgrid.build(mid_map, cell_size=mid_corr)
    return MapProducts(
        grid=grid, target=reg_ops.point_to_plane_target(grid), coarse_grid=coarse_grid,
        coarse_target=reg_ops.point_to_plane_target(coarse_grid), mid_grid=mid_grid,
        mid_layout=hashgrid.nearest_layout(mid_grid),
        hypotheses=to_device(inits, map_cloud.device), coarse_corr=coarse_corr,
        mid_corr=mid_corr, max_corr=max_corr)


def batched_localize(scan_small: PointCloud, scan_mid: PointCloud,
                     scan_rank: PointCloud, scan_full: PointCloud, maps: MapProducts,
                     coarse_iters: int = 10, mid_iters: int = 12,
                     refine_iters: int = 12, top_k: int = 64,
                     profile: Optional[dict] = None, keep: Optional[dict] = None):
    """The multi-resolution funnel (``_batched_localize`` of the JAX
    package, its TPU route) from the hypotheses of ``maps``:

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
    synchronised wall ms is stored under its name.  With ``keep`` (a dict)
    the stages' outputs are stored there as device tensors, with nothing
    pulled: "hypotheses", "coarse_T" (the coarse poses), "rank_score" (their
    scores), "best_idx" (the ``top_k`` taken on) and "mid_T" (their poses
    after step 3), "refined_T" and "refined_fitness" (the winner of step 4),
    "final_T" and "final_fitness", and the clouds "scan_small", "scan_mid",
    "scan_rank" and "scan_full".  Returns (T (4, 4), fitness) as device
    tensors."""
    inits = maps.hypotheses
    clock = _StageClock(profile, inits.device)
    with clock.stage("coarse"):
        coarse = reg_ops.batched_icp_point_to_plane(
            scan_small, maps.coarse_grid, inits, maps.coarse_corr,
            max_iterations=coarse_iters, prepared=maps.coarse_target)
    with clock.stage("rank"):
        # The rank scan's order serves three stages.
        rank_order = nn_layout.query_order(scan_rank.points, scan_rank.mask)
        tight = reg_ops.batched_icp_point_to_plane(
            scan_rank, maps.grid, coarse.transformation, maps.max_corr, max_iterations=0,
            prepared=maps.target, source_order=rank_order)
        score = tight.fitness - tight.inlier_rmse
    with clock.stage("mid"):
        best_idx = torch.sort(score, descending=True, stable=True).indices[:top_k]
        mid = reg_ops.batched_icp_point_to_point(
            scan_mid, maps.mid_grid, coarse.transformation[best_idx], maps.mid_corr,
            max_iterations=mid_iters, layout=maps.mid_layout)
    with clock.stage("refine"):
        refined = reg_ops.batched_icp_point_to_plane(
            scan_rank, maps.grid, mid.transformation, maps.max_corr,
            max_iterations=refine_iters, prepared=maps.target, source_order=rank_order)
        win = torch.argmax(refined.fitness - refined.inlier_rmse)
    with clock.stage("final"):
        final = reg_ops.icp_point_to_plane(
            scan_full, maps.grid, refined.transformation[win], maps.max_corr,
            max_iterations=10, prepared=maps.target)
    if keep is not None:
        keep.update(hypotheses=inits, coarse_T=coarse.transformation, rank_score=score,
                    best_idx=best_idx, mid_T=mid.transformation,
                    refined_T=refined.transformation[win],
                    refined_fitness=refined.fitness[win], final_T=final.transformation,
                    final_fitness=final.fitness, scan_small=scan_small, scan_mid=scan_mid,
                    scan_rank=scan_rank, scan_full=scan_full)
    return final.transformation, final.fitness


def localize(scan: PointCloud, map_products: Callable[[], MapProducts],
             params: SlamParameters, coarse_scan_points: int = 512,
             draw_scores: Optional[Callable[[int, int], torch.Tensor]] = None,
             profile: Optional[dict] = None,
             keep: Optional[dict] = None) -> Tuple[np.ndarray, float]:
    """Localize ``scan`` with no initial pose in the map whose products
    ``map_products()`` returns (a ``prepare_map`` or products kept from
    one); it is called in the prep stage, so a build is timed there.  The
    query's own part: its voxel pass and three seeded subsamples, then the
    funnel.  ``profile`` and ``keep`` as ``batched_localize``'s (``keep``
    also gets the stages' correspondence distances, "coarse_corr",
    "mid_corr" and "max_corr").  Returns (T (4, 4) float64, fitness)."""
    dev = scan.device
    clock = _StageClock(profile, dev)
    sp = params.mapper.scan_processing
    with clock.stage("prep"):
        draw_scores = draw_scores or SeededScores(dev)
        scan_v = voxel.voxel_downsample(scan, max(sp.voxel_size, 1e-3))

        def subsample(n: int, key: int) -> PointCloud:
            kept = voxel.random_downsample(scan_v, n, draw_scores(key, scan_v.capacity))
            return pclib.compact_to(kept, pclib.padded_capacity(n))

        scan_small = subsample(coarse_scan_points, 11)
        scan_mid = subsample(min(1024, scan_v.capacity), 13)
        scan_rank = subsample(min(2048, scan_v.capacity), 12)
        maps = map_products()
        n_hyp = int(maps.hypotheses.shape[0])
        telemetry.count("relocalize.hypotheses", n_hyp)
    if keep is not None:
        keep.update(coarse_corr=float(maps.coarse_corr), mid_corr=float(maps.mid_corr),
                    max_corr=float(maps.max_corr))
    T, fitness = batched_localize(scan_small, scan_mid, scan_rank, scan_v, maps,
                                  top_k=min(64, n_hyp), profile=profile, keep=keep)
    T, fitness = to_host(T, fitness)
    return np.asarray(T, np.float64), float(fitness)


def global_localize(scan: PointCloud, map_cloud: PointCloud,
                    params: SlamParameters, num_hypotheses: int = 1024,
                    coarse_scan_points: int = 512,
                    draw_scores: Optional[Callable[[int, int], torch.Tensor]] = None,
                    profile: Optional[dict] = None,
                    keep: Optional[dict] = None) -> Tuple[np.ndarray, float]:
    """Localize ``scan`` in ``map_cloud`` with no initial pose: ``localize``
    on the map's products built for this call alone (``prepare_map``).
    ``profile`` and ``keep`` as ``localize``'s.  Returns (T (4, 4) float64,
    fitness)."""
    return localize(scan, lambda: prepare_map(map_cloud, params, num_hypotheses), params,
                    coarse_scan_points, draw_scores, profile, keep)
