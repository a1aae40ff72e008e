"""Generalized-ICP registration: the fused Gauss-Newton loop around kernel K1.

Port of the GICP subset of ``open3d_slam_tpu.ops.registration``
(``RegistrationResult``, ``_solve6``, ``_icp_gicp_fused_batch``,
``icp_generalized``).  Semantics are the JAX package's: step from the normal
equations at T, re-evaluate at T_new, stop per batch element on Open3D's
relative fitness/RMSE rule, freeze converged elements.  The port takes the
fused path on every device (the JAX package's unfused hash-grid branch, its
CPU path, is not ported).

``lax.while_loop`` never returns to the host; a Python loop that reads a
device flag does, once per read.  Converged elements freeze (T kept, the
iteration count not advanced), so a few extra iterations after every element
has converged change nothing: the loop reads ``done`` once every
``DONE_CHECK_EVERY`` iterations and gives the same poses and iteration counts
as a check on every iteration, with a quarter of the host syncs.
"""
from __future__ import annotations

import dataclasses
import torch

from open3d_slam_torch.ops import cuda_gicp
from open3d_slam_torch.ops.hashgrid import INT32_MAX, HashGrid
from open3d_slam_torch.utils import se3
from open3d_slam_torch.utils.device import pull_bool
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


def _solve6(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    """Solve batched 6x6 normal equations with Tikhonov jitter 1e-6 *
    trace/6, then Cholesky (no error check, so no host sync)."""
    tr = JtJ.diagonal(dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / 6.0, min=1e-12)
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + (_JITTER * scale)[..., None, None] * eye
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(-Jtr[..., None], L)[..., 0]


def _icp_gicp_fused_batch(points, maskf, n_src, qcov6, td, tv, inits, max_dist,
                          max_iterations, relative_fitness, relative_rmse,
                          t_aabb=None) -> RegistrationResult:
    """Batched GICP GN loop around ``cuda_gicp.gicp_normal_eq``.  Source
    covariances are rotated outside the kernel (R C R^T), the NN search and
    the Mahalanobis normal equations inside."""
    dev = points.device
    r2 = torch.full((1, 1), float(max_dist), dtype=torch.float32, device=dev) ** 2
    bsz = inits.shape[0]

    def stats_eq(T):
        pts = se3.transform_points(T, points).contiguous()
        qc = cuda_gicp.rotate_cov6(T[..., :3, :3], qcov6).contiguous()
        out = cuda_gicp.gicp_normal_eq(pts, maskf, qc, td, tv, r2, t_aabb)
        JtJ, Jtr, n_in, d2s = cuda_gicp.unpack(out)
        fit = n_in / torch.clamp(n_src, min=1.0)
        rmse = torch.sqrt(d2s / torch.clamp(n_in, min=1.0))
        return JtJ, Jtr, fit, rmse

    T = inits
    JtJ, Jtr, fit, rmse = stats_eq(T)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    itg = 0
    while itg < max_iterations:
        dT = se3.se3_exp(_solve6(JtJ, Jtr))
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


def icp_generalized(source: PointCloud, source_covs: torch.Tensor,
                    target_grid: HashGrid, target_covs_sorted: torch.Tensor,
                    init: torch.Tensor, max_correspondence_distance,
                    max_iterations: int = 50, relative_fitness: float = 1e-6,
                    relative_rmse: float = 1e-6) -> RegistrationResult:
    """Generalized (plane-to-plane) ICP, as Open3D
    ``RegistrationGeneralizedICP`` (``CloudRegistration.cpp:16-30``), through
    the fused kernel with the exact per-tile AABB skip (the targets arrive
    spatially sorted, in packed-voxel order)."""
    valid = target_grid.hashes_sorted != INT32_MAX
    td, tv = cuda_gicp.prepare_target(target_grid.points_sorted,
                                      target_covs_sorted, valid)
    n = target_grid.capacity
    t_aabb = (cuda_gicp.tile_aabbs(target_grid.points_sorted, valid).contiguous()
              if n % cuda_gicp.TILE_N == 0 else None)
    maskf = source.mask.to(torch.float32)[:, None].contiguous()
    qcov6 = cuda_gicp.cov6_from_full(source_covs)
    n_src = source.mask.to(torch.float32).sum()
    res = _icp_gicp_fused_batch(
        source.points[None], maskf, n_src, qcov6[None], td, tv,
        init.to(torch.float32)[None], max_correspondence_distance,
        max_iterations, relative_fitness, relative_rmse, t_aabb=t_aabb)
    return RegistrationResult(transformation=res.transformation[0],
                              fitness=res.fitness[0],
                              inlier_rmse=res.inlier_rmse[0],
                              num_iterations=res.num_iterations[0])
