"""ICP registration: Gauss-Newton loops around kernels K1 and K4, and
point-to-point ICP over kernel K3.

Port of ``open3d_slam_tpu.ops.registration`` on its kernel routes:
``RegistrationResult``, ``_solve6``, ``_euler_xyz_transform``,
``_result_stats``, ``_p2p_step``, the fused batched loops
(``_icp_gicp_fused_batch``, ``_icp_p2l_fused_batch``),
``batched_icp_point_to_plane``, ``icp_point_to_plane``, ``icp_generalized``,
``icp_point_to_point`` and ``evaluate_registration``.  Semantics are the JAX
package's: step from the normal equations at T, re-evaluate at T_new, stop
per batch element on Open3D's relative fitness/RMSE rule, freeze converged
elements.  The port takes the fused route on every device (the JAX package's
unfused hash-grid branch, its CPU path, is not ported); point-to-point ICP
finds its correspondences through ``hashgrid.query_nearest`` (K3).

With a ``group`` (a ``torch.distributed`` process group), the source is one
point shard of a cloud split over the group's ranks: the fused loops sum the
kernel's (B, 8, 128) output over the group on every iteration before reading
it, in rank order (``utils.collectives.gather_sum``, the JAX package's
``psum`` over ``axis_name``), so every rank takes the same steps and stops at
the same iteration.

``lax.while_loop`` never returns to the host; a Python loop that reads a
device flag does, once per read.  Converged elements freeze (T kept, the
iteration count not advanced), so a few extra iterations after every element
has converged change nothing: the fused loops read ``done`` once every
``DONE_CHECK_EVERY`` iterations and give the same poses and iteration counts
as a check on every iteration, with a quarter of the host syncs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from open3d_slam_torch.ops import cuda_gicp, cuda_icp, hashgrid, nn_layout
from open3d_slam_torch.ops.hashgrid import INT32_MAX, HashGrid
from open3d_slam_torch.utils import collectives, se3
from open3d_slam_torch.utils.device import pull_bool, to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud

_JITTER = 1e-6
DONE_CHECK_EVERY = 4


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


def _solve6(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    """Solve batched 6x6 normal equations with Tikhonov jitter 1e-6 *
    trace/6, then Cholesky (no error check, so no host sync)."""
    tr = JtJ.diagonal(dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / 6.0, min=1e-12)
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + (_JITTER * scale)[..., None, None] * eye
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(-Jtr[..., None], L)[..., 0]


def _euler_xyz_transform(x: torch.Tensor) -> torch.Tensor:
    """6-vector (alpha, beta, gamma, tx, ty, tz) -> 4x4 via Rz*Ry*Rx + t:
    Open3D's ``TransformVector6dToMatrix4d``, the retraction of its
    point-to-plane solver."""
    R = se3.rpy_to_matrix(x[..., 0], x[..., 1], x[..., 2])
    return se3.make_transform(R, x[..., 3:6])


def _result_stats(d2: torch.Tensor, w: torch.Tensor, source_mask: torch.Tensor):
    """(fitness, rmse) over the last axis: inlier fraction of the valid
    source points, RMS distance over the inliers."""
    n_src = source_mask.to(torch.float32).sum(-1)
    n_in = w.to(torch.float32).sum(-1)
    d2_sum = torch.where(w, d2, torch.zeros_like(d2)).sum(-1)
    fitness = n_in / torch.clamp(n_src, min=1.0)
    rmse = torch.sqrt(d2_sum / torch.clamp(n_in, min=1.0))
    return fitness, rmse


def _p2p_moments(pts: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Weighted centroids and cross-covariance of ``_p2p_step``: pts, q
    (B, M, 3), w (B, M) -> H (B, 3, 3), p_bar, q_bar (B, 3)."""
    wf = w.to(pts.dtype)[..., None]
    n = torch.clamp(wf.sum(-2), min=1.0)
    p_bar = (pts * wf).sum(-2) / n
    q_bar = (q * wf).sum(-2) / n
    P = (pts - p_bar[..., None, :]) * wf
    Q = q - q_bar[..., None, :]
    return P.transpose(-1, -2) @ Q, p_bar, q_bar


def _p2p_step(H: np.ndarray, p_bar: np.ndarray, q_bar: np.ndarray) -> np.ndarray:
    """Weighted Kabsch (Umeyama without scaling, as Open3D) from the
    moments, on the host in float32 with LAPACK's SVD, one matrix at a time:
    (B, 3, 3), (B, 3), (B, 3) -> dT (B, 4, 4).  On the card a batched SVD
    may take another cuSOLVER routine than a single one; on the host every
    hypothesis of a batch gets the same step as it would alone."""
    H, p_bar, q_bar = (np.asarray(a, np.float32) for a in (H, p_bar, q_bar))
    U, _, Vt = np.linalg.svd(H)
    V, Ut = np.swapaxes(Vt, -1, -2), np.swapaxes(U, -1, -2)
    d = np.sign(np.linalg.det(V @ Ut)).astype(np.float32)
    D = np.zeros(H.shape, np.float32)
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = d
    R = V @ D @ Ut
    dT = np.zeros((H.shape[0], 4, 4), np.float32)
    dT[:, :3, :3] = R
    dT[:, :3, 3] = q_bar - (R @ p_bar[..., None])[..., 0]
    dT[:, 3, 3] = 1.0
    return dT


def _gauss_newton(stats_eq: Callable, inits: torch.Tensor, max_iterations: int,
                  relative_fitness: float, relative_rmse: float,
                  retract: Callable) -> RegistrationResult:
    """The Gauss-Newton loop of both fused loops: ``stats_eq(T)`` gives
    (JtJ, Jtr, fitness, rmse) for the batch of poses T, ``retract`` turns a
    6-vector step into a 4x4 update applied on the left."""
    dev = inits.device
    bsz = inits.shape[0]
    T = inits
    JtJ, Jtr, fit, rmse = stats_eq(T)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    itg = 0
    while itg < max_iterations:
        dT = retract(_solve6(JtJ, Jtr))
        T_new = torch.where(done[:, None, None], T, dT @ T)
        JtJ, Jtr, fitn, rmsen = stats_eq(T_new)
        conv = ((fit - fitn).abs() < relative_fitness) & \
            ((rmse - rmsen).abs() < relative_rmse)
        it = it + (~done).to(torch.int32)
        T, fit, rmse, done = T_new, fitn, rmsen, done | conv
        itg += 1
        if itg % DONE_CHECK_EVERY == 0 and pull_bool(done.all()):
            break
    return RegistrationResult(transformation=T, fitness=fit, inlier_rmse=rmse,
                              num_iterations=it)


def _stats(out: torch.Tensor, n_src: torch.Tensor, group=None):
    """(JtJ, Jtr, fitness, rmse) of a fused kernel's output, summed over
    ``group`` first when there is one."""
    if group is not None:
        out = collectives.gather_sum(out, group)
    JtJ, Jtr, n_in, d2s = cuda_gicp.unpack(out)
    fit = n_in / torch.clamp(n_src, min=1.0)
    rmse = torch.sqrt(d2s / torch.clamp(n_in, min=1.0))
    return JtJ, Jtr, fit, rmse


def _source_order(source: PointCloud, order: Optional[torch.Tensor]) -> torch.Tensor:
    """The sweep's query order of ``source``: ``order`` when given (the
    Morton order of the same points and mask, e.g. from the layout of the
    cloud as an earlier target), else made here."""
    return order if order is not None else nn_layout.query_order(source.points, source.mask)


def _r2(max_dist, device) -> torch.Tensor:
    return torch.full((1, 1), float(max_dist), dtype=torch.float32, device=device) ** 2


def _icp_gicp_fused_batch(points, maskf, n_src, qcov6, td, tv, inits, max_dist,
                          max_iterations, relative_fitness, relative_rmse,
                          layout=None, group=None) -> RegistrationResult:
    """Batched GICP GN loop around ``cuda_gicp.gicp_normal_eq``.  Source
    covariances are rotated outside the kernel (R C R^T), the NN search and
    the Mahalanobis normal equations inside; the exp retraction.  ``layout``
    (``nn_layout.SweepLayout``) holds for every iteration.  With ``group``
    the points are this rank's shard and ``n_src`` the valid points of the
    whole cloud."""
    r2 = _r2(max_dist, points.device)

    def stats_eq(T):
        pts = se3.transform_points(T, points).contiguous()
        qc = cuda_gicp.rotate_cov6(T[..., :3, :3], qcov6).contiguous()
        return _stats(cuda_gicp.gicp_normal_eq(pts, maskf, qc, td, tv, r2, None, layout),
                      n_src, group)

    return _gauss_newton(stats_eq, inits, max_iterations, relative_fitness,
                         relative_rmse, se3.se3_exp)


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
    r2 = _r2(max_dist, inits.device)

    def stats_eq(T):
        pts = se3.transform_points(T, points).contiguous()
        return _stats(cuda_icp.p2l_normal_eq(pts, maskf, t_t, tn_t, tc, tv, r2, layout),
                      n_src, group)

    return _gauss_newton(stats_eq, inits, max_iterations, relative_fitness,
                         relative_rmse,
                         se3.se3_exp if use_exp_retraction else _euler_xyz_transform)


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


def batched_icp_point_to_point(source: PointCloud, target_grid: HashGrid,
                               inits: torch.Tensor, max_correspondence_distance,
                               max_iterations: int = 30,
                               relative_fitness: float = 1e-6,
                               relative_rmse: float = 1e-6) -> RegistrationResult:
    """Point-to-point ICP of one source cloud from each of the (B, 4, 4)
    ``inits`` against one target grid: each iteration finds the
    correspondences of every hypothesis in one K3 launch, and each
    hypothesis's result is that of ``icp_point_to_point`` from its init
    alone (converged hypotheses freeze).  K3's layout of the grid and the
    Morton order of the untransformed source, which every pose shares, are
    made once per call.  The Kabsch step's SVD runs on the host, one counted
    pull of the (B, 3, 3) moments per iteration, which also reads
    ``done``."""
    dev = inits.device
    bsz = inits.shape[0]
    max_dist = float(max_correspondence_distance)
    layout = hashgrid.nearest_layout(target_grid)
    order = nn_layout.query_order(source.points, source.mask)

    def corr_stats(T):
        pts = se3.transform_points(T, source.points)
        idx, d2, w = hashgrid.query_nearest(target_grid, pts, max_dist, layout, order,
                                            source.mask)
        fit, rmse = _result_stats(d2, w, source.mask)
        return pts, idx, w, fit, rmse

    T = inits.to(torch.float32)
    pts, idx, w, fit, rmse = corr_stats(T)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        q = target_grid.points_sorted[idx.long()]
        H, p_bar, q_bar, done_h = to_host(*_p2p_moments(pts, q, w), done)
        if done_h.all():
            break
        dT = to_device(_p2p_step(H, p_bar, q_bar), dev)
        T_new = torch.where(done[:, None, None], T, dT @ T)
        pts, idx, w, fitn, rmsen = corr_stats(T_new)
        conv = ((fit - fitn).abs() < relative_fitness) & \
            ((rmse - rmsen).abs() < relative_rmse)
        it = it + (~done).to(torch.int32)
        T, fit, rmse, done = T_new, fitn, rmsen, done | conv
    return RegistrationResult(transformation=T, fitness=fit, inlier_rmse=rmse,
                              num_iterations=it)


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
