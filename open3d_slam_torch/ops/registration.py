"""ICP registration: Gauss-Newton loops around kernels K1 and K4, and
point-to-point ICP over kernel K3.

Port of ``open3d_slam_tpu.ops.registration`` on its kernel routes:
``RegistrationResult``, ``_result_stats``, the fused batched loops
(``_icp_gicp_fused_batch``, ``_icp_p2l_fused_batch``),
``batched_icp_point_to_plane``, ``icp_point_to_plane``, ``icp_generalized``,
``icp_point_to_point`` (its Kabsch step ``_p2p_step`` is
``cuda_p2p.p2p_step``) and ``evaluate_registration``.  Semantics are the JAX
package's: step from the normal equations (or the Kabsch moments) at T,
re-evaluate at T_new, stop per batch element on Open3D's relative
fitness/RMSE rule, freeze converged elements.  A fused loop's iteration
is three wrapper calls: ``cuda_gn_step.gn_apply`` (the source at the poses
P), K1's or K4's sweep there, and ``cuda_gn_step.gn_step`` (the statistics,
the stop test, and the next step from the same normal equations, which the
JAX loop takes at the top of its next iteration; the JAX ``_solve6`` and
``_euler_xyz_transform`` are ``cuda_gn_step.solve6_chain`` and
``euler_xyz_transform``, in its plain version).  The port takes the fused
route on every device (the JAX package's unfused hash-grid branch, its CPU
path, is not ported); point-to-point ICP finds its correspondences through
``hashgrid.query_nearest`` (K3).

With a ``group`` (a ``torch.distributed`` process group), the source is one
point shard of a cloud split over the group's ranks: the fused loops sum the
kernel's (B, 8, 128) output over the group on every iteration before reading
it, in rank order (``utils.collectives.gather_sum``, the JAX package's
``psum`` over ``axis_name``), so every rank takes the same steps and stops at
the same iteration.

Every loop goes through ``gn_graph.run``, which decides its path.  The
loops' iterations on the card, with no ``group``, are replays of CUDA
graphs (``ops/gn_graph.py``), the counterpart of the JAX package's
``lax.while_loop``: the start and chunks of ``gn_graph.DONE_CHECK_EVERY``
iterations, with one counted read of ``done`` between chunks.  Converged
elements freeze (T kept, the iteration count not advanced), so a few extra
iterations after every element has converged change nothing, and the poses
and iteration counts are those of a check on every iteration.  On the CPU
and with a ``group`` the same iteration (``_gn_iteration``, or the
point-to-point loop's) runs eagerly, in the same chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from open3d_slam_torch.ops import cuda_gicp, cuda_gn_step, cuda_icp, cuda_p2p, gn_graph
from open3d_slam_torch.ops import hashgrid, nn_layout
from open3d_slam_torch.ops.gn_graph import GNState
from open3d_slam_torch.ops.hashgrid import INT32_MAX, HashGrid
from open3d_slam_torch.utils import collectives, se3
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry


@dataclasses.dataclass(frozen=True)
class RegistrationResult:
    """Mirror of Open3D ``RegistrationResult`` (tensors on the device)."""

    transformation: torch.Tensor   # (4, 4) or (B, 4, 4)
    fitness: torch.Tensor          # inlier fraction of valid source points
    inlier_rmse: torch.Tensor      # RMS Euclidean distance over inliers
    num_iterations: torch.Tensor   # int32

    def __getitem__(self, i) -> "RegistrationResult":
        """Element ``i`` of a batched result."""
        return RegistrationResult(self.transformation[i], self.fitness[i],
                                  self.inlier_rmse[i], self.num_iterations[i])


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (the row padded with
    zeros to a power of two, then its halves added elementwise until one
    entry is left).  A reduction kernel's order can change with the number
    of rows (it does on the card), and the point-to-point loop keeps each
    hypothesis's result independent of the batch."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], width - n)], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _result_stats(d2: torch.Tensor, w: torch.Tensor, source_mask: torch.Tensor):
    """(fitness, rmse) over the last axis: inlier fraction of the valid
    source points, RMS distance over the inliers.  The counts are exact in
    any order; the d2 sum is taken in ``_row_sum``'s fixed order."""
    n_src = source_mask.to(torch.float32).sum(-1)
    n_in = w.to(torch.float32).sum(-1)
    d2_sum = _row_sum(torch.where(w, d2, torch.zeros_like(d2)))
    fitness = n_in / torch.clamp(n_src, min=1.0)
    rmse = torch.sqrt(d2_sum / torch.clamp(n_in, min=1.0))
    return fitness, rmse


def _gn_start(sweep: Callable, inits: torch.Tensor, n_src: torch.Tensor,
              exp_retraction: bool) -> GNState:
    """The loop's first state: the statistics at the initial poses and the
    first step from them (``cuda_gn_step.gn_step`` without a stop test)."""
    return cuda_gn_step.gn_step(sweep(inits), n_src, inits, None, exp_retraction)


def _gn_iteration(s: GNState, sweep: Callable, n_src: torch.Tensor, exp_retraction: bool,
                  relative_fitness: float, relative_rmse: float) -> GNState:
    """One Gauss-Newton iteration: the sweep at the poses ``s.P`` (the step
    the previous state took from its normal equations, or its poses where it
    was done; ``sweep(P)`` gives the fused kernel's (B, 8, 128) output),
    then ``cuda_gn_step.gn_step``: the statistics there, Open3D's relative
    fitness/RMSE stop test against ``s``'s, and the next step from the same
    normal equations (``exp_retraction``: the SE(3) exponential, else the
    Euler-XYZ transform), applied on the left; converged elements freeze."""
    return cuda_gn_step.gn_step(sweep(s.P), n_src, s.P, s, exp_retraction, relative_fitness,
                                relative_rmse)


def _gauss_newton(kind: str, inputs: dict, make_sweep: Callable,
                  layout: nn_layout.SweepLayout, max_dist, max_iterations: int,
                  relative_fitness: float, relative_rmse: float, exp_retraction: bool,
                  group=None) -> RegistrationResult:
    """The Gauss-Newton loop of both fused loops.  ``inputs`` holds the
    loop's tensors ("inits", "points", "n_src", ..., "r2"), ``layout`` the
    sweep's; ``make_sweep(x)`` builds ``sweep(P)`` on a dict of them and of
    the layout's (``_sweep_layout``).  On the card without ``group`` the
    iterations are CUDA-graph replays on static copies of the inputs
    (``gn_graph.run``), else they run eagerly on the inputs themselves."""
    def program(x):
        sweep = make_sweep(x)
        return (lambda: _gn_start(sweep, x["inits"], x["n_src"], exp_retraction),
                lambda s: _gn_iteration(s, sweep, x["n_src"], exp_retraction,
                                        relative_fitness, relative_rmse))

    # A group's loop sums the kernel's output over its ranks on every
    # iteration (``_summed``), which no graph holds: it runs eagerly.
    state = gn_graph.run(kind, (exp_retraction, float(max_dist), relative_fitness,
                                relative_rmse),
                         {**inputs, **_layout_inputs(layout)}, program, max_iterations,
                         eager=group is not None)
    return RegistrationResult(transformation=state.T, fitness=state.fit,
                              inlier_rmse=state.rmse, num_iterations=state.it)


def _layout_inputs(layout: nn_layout.SweepLayout) -> dict:
    t = layout.target
    return {"t_pts": t.pts, "t_boxes": t.boxes, "t_order": t.order,
            "query_order": layout.query_order}


def _sweep_layout(x: dict) -> nn_layout.SweepLayout:
    """The sweep layout held in the loop's inputs ``x``, bound to their
    target coordinates and validity as they are now (a static call's
    copy-in changes them together)."""
    coords = x["td"] if "td" in x else x["t_t"]
    target = nn_layout.TargetLayout(x["t_pts"], x["t_boxes"], x["t_order"])
    return nn_layout.SweepLayout(nn_layout.bind(target, coords, x["tv"]), x["query_order"])


def _summed(out: torch.Tensor, group) -> torch.Tensor:
    """A fused kernel's output summed over ``group`` in rank order, when
    there is one."""
    return out if group is None else collectives.gather_sum(out, group)


def _source_order(source: PointCloud, order: Optional[torch.Tensor]) -> torch.Tensor:
    """The sweep's query order of ``source``: ``order`` when given (the
    Morton order of the same points and mask, e.g. from the layout of the
    cloud as an earlier target), else made here (the calling layer's
    ``query_order`` span)."""
    if order is not None:
        return order
    with telemetry.stage("query_order"):
        return nn_layout.query_order(source.points, source.mask)


def _r2(max_dist, device) -> torch.Tensor:
    return torch.full((1, 1), float(max_dist), dtype=torch.float32, device=device) ** 2


@telemetry.spanned("gn_loop.gicp")
def _icp_gicp_fused_batch(points, maskf, n_src, qcov6, td, tv, inits, max_dist,
                          max_iterations, relative_fitness, relative_rmse,
                          layout=None, group=None) -> RegistrationResult:
    """Batched GICP GN loop around ``cuda_gicp.gicp_normal_eq``.  Source
    covariances are rotated outside the kernel (R C R^T), the NN search and
    the Mahalanobis normal equations inside; the exp retraction.  ``layout``
    (``nn_layout.SweepLayout``) holds for every iteration.  With ``group``
    the points are this rank's shard and ``n_src`` the valid points of the
    whole cloud."""
    b, m = inits.shape[0], points.shape[-2]
    if layout is None:
        layout = nn_layout.layout_for(points.expand(b, m, 3), maskf, td, tv)
    nn_layout.check_layout(layout, b, m, td.shape[-1], points.device, td, tv)

    def make_sweep(x):
        def sweep(P):
            pts, qc = cuda_gn_step.gn_apply(P, x["points"], x["qcov6"])
            out = cuda_gicp.gicp_normal_eq(pts, x["maskf"], qc, x["td"], x["tv"], x["r2"],
                                           None, _sweep_layout(x))
            return _summed(out, group)
        return sweep

    inputs = dict(inits=inits.contiguous(), points=points, maskf=maskf, n_src=n_src,
                  qcov6=qcov6, td=td, tv=tv, r2=_r2(max_dist, points.device))
    return _gauss_newton("gicp", inputs, make_sweep, layout, max_dist, max_iterations,
                         relative_fitness, relative_rmse, True, group)


@telemetry.spanned("gn_loop.p2l")
def _icp_p2l_fused_batch(points, maskf, n_src, t_t, tn_t, tc, tv, inits, max_dist,
                         max_iterations, relative_fitness, relative_rmse,
                         use_exp_retraction=False, layout=None,
                         group=None) -> RegistrationResult:
    """Batched point-to-plane GN loop around ``cuda_icp.p2l_normal_eq``:
    one kernel call per iteration gives the correspondences, the 6x6 normal
    equations and the fitness statistics of the whole batch.  The Euler-XYZ
    retraction unless ``use_exp_retraction``.  ``layout``
    (``nn_layout.SweepLayout``) holds for every iteration.  With ``group``
    the points are this rank's shard and ``n_src`` the valid points of the
    whole cloud."""
    b, m = inits.shape[0], points.shape[-2]
    if layout is None:
        layout = nn_layout.layout_for(points.expand(b, m, 3), maskf, t_t, tv)
    nn_layout.check_layout(layout, b, m, t_t.shape[-1], points.device, t_t, tv)

    def make_sweep(x):
        def sweep(P):
            pts, _ = cuda_gn_step.gn_apply(P, x["points"])
            out = cuda_icp.p2l_normal_eq(pts, x["maskf"], x["t_t"], x["tn_t"], x["tc"],
                                         x["tv"], x["r2"], _sweep_layout(x))
            return _summed(out, group)
        return sweep

    inputs = dict(inits=inits.contiguous(), points=points, maskf=maskf, n_src=n_src,
                  t_t=t_t, tn_t=tn_t, tc=tc, tv=tv, r2=_r2(max_dist, inits.device))
    return _gauss_newton("p2l", inputs, make_sweep, layout, max_dist, max_iterations,
                         relative_fitness, relative_rmse, use_exp_retraction, group)


def point_to_plane_target(grid: HashGrid) -> tuple:
    """K4's target arrays and sweep layout of a grid with normals
    (``cuda_icp.prepare_target``)."""
    if grid.normals_sorted is None:
        raise ValueError("point-to-plane ICP needs a target grid with normals")
    return cuda_icp.prepare_target(grid.points_sorted, grid.normals_sorted,
                                   grid.hashes_sorted != INT32_MAX)


def batched_icp_point_to_plane(source: PointCloud, target_grid: HashGrid,
                               inits: torch.Tensor, max_correspondence_distance,
                               max_iterations: int = 30,
                               relative_fitness: float = 1e-6,
                               relative_rmse: float = 1e-6,
                               use_exp_retraction: bool = False,
                               prepared: Optional[tuple] = None,
                               source_order: Optional[torch.Tensor] = None,
                               group=None) -> RegistrationResult:
    """Natively batched fused point-to-plane ICP (kernel K4).  Two layouts,
    told apart by rank:

      * per element: ``source``/``target_grid`` tensors carry a leading
        batch dim matching ``inits`` (B, 4, 4);
      * shared: ``source``/``target_grid`` are single clouds and only
        ``inits`` is batched (multi-start localization: the map is stored
        once and swept once per kernel call for the whole batch).

    The target grid must carry normals.  The kernel's target arrays and
    sweep layout are made once here, unless given: ``prepared``, what
    ``cuda_icp.prepare_target`` returned for the grid (the grid is then not
    read), and ``source_order``, the Morton order of the untransformed
    source.  With ``group``, ``source`` is this rank's point shard of the
    cloud the group's ranks split between them (``icp_point_to_plane``)."""
    if prepared is None:
        prepared = point_to_plane_target(target_grid)
    t_t, tn_t, tc, tv, t_layout = prepared
    layout = nn_layout.SweepLayout(t_layout, _source_order(source, source_order))
    maskf = source.mask.to(torch.float32)[..., None].contiguous()
    n_src = source.mask.to(torch.float32).sum(-1)
    if group is not None:
        n_src = collectives.gather_sum(n_src, group)
    return _icp_p2l_fused_batch(
        source.points, maskf, n_src, t_t, tn_t, tc, tv,
        inits.to(torch.float32), max_correspondence_distance, max_iterations,
        relative_fitness, relative_rmse, use_exp_retraction, layout, group)


def icp_point_to_plane(source: PointCloud, target_grid: HashGrid, init: torch.Tensor,
                       max_correspondence_distance, max_iterations: int = 50,
                       relative_fitness: float = 1e-6, relative_rmse: float = 1e-6,
                       use_exp_retraction: bool = False,
                       prepared: Optional[tuple] = None,
                       source_order: Optional[torch.Tensor] = None,
                       group=None) -> RegistrationResult:
    """Point-to-plane ICP of ``source`` against a target grid with normals,
    as Open3D ``RegistrationICP`` with ``TransformationEstimationPointToPlane``
    (``CloudRegistration.cpp:44-48``), through kernel K4.

    ``group``: ``source`` is this rank's POINT SHARD of a larger cloud split
    over the group's ranks; the valid-point count is summed once and the
    kernel's normal equations and fitness statistics on every iteration
    (``utils.collectives.gather_sum``), so every rank runs the identical
    Gauss-Newton update (the JAX package's ``axis_name``)."""
    res = batched_icp_point_to_plane(
        source.with_(points=source.points[None]), target_grid, init[None],
        max_correspondence_distance, max_iterations, relative_fitness,
        relative_rmse, use_exp_retraction, prepared, source_order, group)
    return res[0]


def icp_generalized(source: PointCloud, source_covs: torch.Tensor,
                    target_grid: HashGrid, target_covs_sorted: torch.Tensor,
                    init: torch.Tensor, max_correspondence_distance,
                    max_iterations: int = 50, relative_fitness: float = 1e-6,
                    relative_rmse: float = 1e-6,
                    prepared: Optional[tuple] = None,
                    source_order: Optional[torch.Tensor] = None,
                    group=None) -> RegistrationResult:
    """Generalized (plane-to-plane) ICP, as Open3D
    ``RegistrationGeneralizedICP`` (``CloudRegistration.cpp:16-30``), through
    the fused kernel with its exact tile skip.  The targets arrive in the
    grid's order (a hash order from ``hashgrid.build``, the packed-voxel
    order of the cloud from ``cloud_registration``), which keeps no tile of
    targets compact; the kernel sweeps a Morton layout of the target and of
    the untransformed source.  Both are made here unless given:
    ``prepared``, what ``cuda_gicp.prepare_target`` returned for the grid
    and its covariances (they are then not read), and ``source_order``.
    ``group``: ``source`` and ``source_covs`` are this rank's point shard,
    as in ``icp_point_to_plane``."""
    if prepared is None:
        prepared = cuda_gicp.prepare_target(target_grid.points_sorted, target_covs_sorted,
                                            target_grid.hashes_sorted != INT32_MAX)
    td, tv, t_layout = prepared
    layout = nn_layout.SweepLayout(t_layout, _source_order(source, source_order))
    maskf = source.mask.to(torch.float32)[:, None].contiguous()
    qcov6 = cuda_gicp.cov6_from_full(source_covs)
    n_src = source.mask.to(torch.float32).sum()
    if group is not None:
        n_src = collectives.gather_sum(n_src, group)
    res = _icp_gicp_fused_batch(
        source.points[None], maskf, n_src, qcov6[None], td, tv,
        init.to(torch.float32)[None], max_correspondence_distance,
        max_iterations, relative_fitness, relative_rmse, layout=layout, group=group)
    return res[0]


class P2PState(NamedTuple):
    T: torch.Tensor      # (B, 4, 4) poses
    idx: torch.Tensor    # (B, M) int32 correspondences at T, into the grid's sorted points
    w: torch.Tensor      # (B, M) bool inliers at T
    fit: torch.Tensor    # (B,) fitness at T
    rmse: torch.Tensor   # (B,) inlier RMSE at T
    it: torch.Tensor     # (B,) int32 iterations taken
    done: torch.Tensor   # (B,) bool converged (frozen)


def _apply_left(dT: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """dT @ T for (..., 4, 4), each entry summed in the order
    ((a0 + a1) + a2) + a3 by elementwise operations: a batched product's
    order can change with the batch size (cuBLAS's does)."""
    out = dT[..., :, 0:1] * T[..., 0:1, :]
    for k in range(1, 4):
        out = out + dT[..., :, k:k + 1] * T[..., k:k + 1, :]
    return out


def _p2p_program(x: dict, cell_size: float, max_dist: float, relative_fitness: float,
                 relative_rmse: float) -> gn_graph.Program:
    """The point-to-point loop on the dict ``x`` (the source "points",
    "mask" and "query_order", the "inits", and the target grid and K3's
    layout of it, ``_grid`` and ``_nearest_layout``): the start (the
    correspondences at the initial poses) and one iteration (the JAX loop's
    body): gather the correspondences, the Kabsch step
    (``cuda_p2p.p2p_step``), T_new = dT T, the correspondences at T_new,
    Open3D's relative fitness/RMSE rule; converged hypotheses freeze."""
    def corr(T):
        pts = se3.transform_points(T, x["points"])
        idx, d2, w = hashgrid.query_nearest(_grid(x, cell_size), pts, max_dist,
                                            _nearest_layout(x), x["query_order"], x["mask"])
        fit, rmse = _result_stats(d2, w, x["mask"])
        return idx, w, fit, rmse

    def start():
        T = x["inits"]
        bsz = T.shape[0]
        return P2PState(T, *corr(T), torch.zeros(bsz, dtype=torch.int32, device=T.device),
                        torch.zeros(bsz, dtype=torch.bool, device=T.device))

    def step(s: P2PState) -> P2PState:
        pts = se3.transform_points(s.T, x["points"])
        q = x["t_points"][s.idx.long()]
        dT = cuda_p2p.p2p_step(pts, q, s.w)
        T_new = torch.where(s.done[:, None, None], s.T, _apply_left(dT, s.T))
        idx, w, fitn, rmsen = corr(T_new)
        conv = ((s.fit - fitn).abs() < relative_fitness) & \
            ((s.rmse - rmsen).abs() < relative_rmse)
        return P2PState(T_new, idx, w, fitn, rmsen, s.it + (~s.done).to(torch.int32),
                        s.done | conv)

    return start, step


def _grid(x: dict, cell_size: float) -> HashGrid:
    """The target grid held in ``x``."""
    return HashGrid(hashes_sorted=x["t_hashes"], points_sorted=x["t_points"],
                    normals_sorted=None, order=x["t_grid_order"], cell_size=cell_size)


def _nearest_layout(x: dict) -> nn_layout.TargetLayout:
    """K3's layout held in ``x``, bound to its target points and hashes as
    they are now (a call's copy-in changes them together)."""
    target = nn_layout.TargetLayout(x["t_pts"], x["t_boxes"], x["t_order"])
    return nn_layout.bind(target, x["t_points"], x["t_hashes"])


@telemetry.spanned("gn_loop.p2p")
def batched_icp_point_to_point(source: PointCloud, target_grid: HashGrid,
                               inits: torch.Tensor, max_correspondence_distance,
                               max_iterations: int = 30,
                               relative_fitness: float = 1e-6,
                               relative_rmse: float = 1e-6,
                               layout: Optional[nn_layout.TargetLayout] = None
                               ) -> RegistrationResult:
    """Point-to-point ICP of one source cloud from each of the (B, 4, 4)
    ``inits`` against one target grid: each iteration finds the
    correspondences of every hypothesis in one K3 launch and takes every
    hypothesis's Kabsch step in one ``cuda_p2p.p2p_step`` launch, and each
    hypothesis's result is that of ``icp_point_to_point`` from its init
    alone, bit for bit (converged hypotheses freeze; the kernels treat
    hypotheses apart, and the loop's sums and products are taken in orders
    that do not depend on the batch: ``_row_sum``, ``_apply_left``).  K3's
    layout of the grid (``layout``, ``hashgrid.nearest_layout(target_grid)``
    made here unless given) and the Morton order of the untransformed
    source, which every pose shares, serve the whole call.  On the card the
    iterations are CUDA-graph replays (``gn_graph.run``) on static copies of
    the inputs, with one counted read of ``done`` per chunk; elsewhere they
    run eagerly in the same chunks."""
    max_dist = float(max_correspondence_distance)
    if layout is None:
        layout = hashgrid.nearest_layout(target_grid)
    inputs = dict(inits=inits.to(torch.float32).contiguous(), points=source.points,
                  mask=source.mask,
                  query_order=nn_layout.query_order(source.points, source.mask),
                  t_points=target_grid.points_sorted, t_hashes=target_grid.hashes_sorted,
                  t_grid_order=target_grid.order, t_pts=layout.pts, t_boxes=layout.boxes,
                  t_order=layout.order)

    consts = (target_grid.cell_size, max_dist, relative_fitness, relative_rmse)
    state = gn_graph.run("p2p", consts, inputs, lambda x: _p2p_program(x, *consts),
                         max_iterations)
    return RegistrationResult(transformation=state.T, fitness=state.fit,
                              inlier_rmse=state.rmse, num_iterations=state.it)


def icp_point_to_point(source: PointCloud, target_grid: HashGrid, init: torch.Tensor,
                       max_correspondence_distance, max_iterations: int = 30,
                       relative_fitness: float = 1e-6,
                       relative_rmse: float = 1e-6) -> RegistrationResult:
    """Point-to-point ICP (Umeyama closed form per iteration, like Open3D
    ``TransformationEstimationPointToPoint``)."""
    return batched_icp_point_to_point(
        source, target_grid, init[None], max_correspondence_distance,
        max_iterations, relative_fitness, relative_rmse)[0]


def evaluate_registration(source: PointCloud, target_grid: HashGrid,
                          T: torch.Tensor, max_correspondence_distance
                          ) -> RegistrationResult:
    """Fitness/RMSE of a fixed transform (Open3D ``EvaluateRegistration``)."""
    pts = se3.transform_points(T.to(torch.float32), source.points)
    _, d2, w = hashgrid.query_nearest(target_grid, pts, float(max_correspondence_distance),
                                      query_mask=source.mask)
    fit, rmse = _result_stats(d2, w, source.mask)
    return RegistrationResult(transformation=T, fitness=fit, inlier_rmse=rmse,
                              num_iterations=torch.zeros((), dtype=torch.int32,
                                                         device=T.device))
