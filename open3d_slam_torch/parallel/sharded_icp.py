"""Sharded registration: batch-parallel and point-shard-parallel ICP.

Port of ``open3d_slam_tpu.parallel.sharded_icp``.  Two axes of the mesh
(``parallel/mesh.py``):
  * ``data``  — a batch of independent registrations (scan pairs of an
    odometry batch, constraint pairs, sequences), each rank running its
    contiguous slice through kernel K4 with a target per element, the
    results gathered in rank order;
  * ``block`` — the source cloud of one registration split into point
    shards: on every Gauss-Newton iteration each rank finds the
    correspondences of its shard (K4, or K1 for GICP) and the normal
    equations are summed over the block group in rank order
    (``mesh.gather_sum``), so every rank steps the identical pose
    (``make_block_sharded_icp``, ``make_block_sharded_gicp``).
"""
from __future__ import annotations

import torch

from open3d_slam_torch.ops import registration as reg_ops
from open3d_slam_torch.ops.hashgrid import HashGrid
from open3d_slam_torch.parallel import mesh as mesh_lib
from open3d_slam_torch.utils.pointcloud import PointCloud


def batched_icp_p2l(sources: PointCloud, grids: HashGrid, inits: torch.Tensor,
                    max_correspondence_distance, max_iterations: int = 30,
                    mesh=None) -> reg_ops.RegistrationResult:
    """Point-to-plane ICP over a leading batch axis: ``sources`` (B, M),
    ``grids`` (B, N) (``hashgrid.build_batched``, with normals) and
    ``inits`` (B, 4, 4).  Every rank holds the whole batch; with ``mesh``
    each runs its slice on the ``data`` axis (``mesh.shard_batch``) through
    ``batched_icp_point_to_plane`` (one K4 launch per iteration for its
    slice) and every rank returns the whole batch's result, gathered in
    rank order.  Each element's result is the one it gets alone."""
    if mesh is not None:
        sources, grids, inits = mesh_lib.shard_batch(mesh, (sources, grids, inits))
    res = reg_ops.batched_icp_point_to_plane(sources, grids, inits,
                                             max_correspondence_distance,
                                             max_iterations=max_iterations)
    if mesh is None:
        return res
    group = mesh_lib.data_group(mesh)
    return reg_ops.RegistrationResult(
        *(mesh_lib.gather_cat(t, group) for t in (res.transformation, res.fitness,
                                                  res.inlier_rmse, res.num_iterations)))


def make_block_sharded_icp(mesh, max_correspondence_distance, max_iterations: int = 30):
    """Point-shard-parallel single registration over the ``block`` axis.

    Returns ``run(source_shards, grid, init)`` where ``source_shards`` has
    its point axis split into [n_block, points / n_block]
    (``split_points_for_blocks``) and the target grid is replicated: each
    rank registers shard ``[its block coordinate]`` with
    ``icp_point_to_plane(..., group=block group)``, which sums the shards'
    normal equations on every iteration."""
    group = mesh_lib.block_group(mesh)
    i = mesh.get_local_rank(mesh.mesh_dim_names[1])

    def run(source_shards: PointCloud, grid: HashGrid,
            init: torch.Tensor) -> reg_ops.RegistrationResult:
        local = mesh_lib.map_tensors(lambda x: x[i], source_shards)
        return reg_ops.icp_point_to_plane(local, grid, init, max_correspondence_distance,
                                          max_iterations=max_iterations, group=group)

    return run


def make_block_sharded_gicp(mesh, max_correspondence_distance, max_iterations: int = 30):
    """The GICP counterpart of ``make_block_sharded_icp`` (kernel K1).

    Returns ``run(source_shards, source_cov_shards, target_grid,
    target_covs_sorted, init, prepared=None)``: the source cloud and its
    (N, 3, 3) covariances split into [n_block, N / n_block] shards
    (``split_points_for_blocks``), the target replicated; each rank
    registers shard ``[its block coordinate]`` with
    ``icp_generalized(..., group=block group)``.  ``prepared`` is what
    ``cuda_gicp.prepare_target`` returned for the target, as
    ``icp_generalized`` takes it."""
    group = mesh_lib.block_group(mesh)
    i = mesh.get_local_rank(mesh.mesh_dim_names[1])

    def run(source_shards: PointCloud, source_cov_shards: torch.Tensor, target_grid,
            target_covs_sorted, init: torch.Tensor,
            prepared=None) -> reg_ops.RegistrationResult:
        local = mesh_lib.map_tensors(lambda x: x[i], source_shards)
        return reg_ops.icp_generalized(local, source_cov_shards[i], target_grid,
                                       target_covs_sorted, init, max_correspondence_distance,
                                       max_iterations=max_iterations, prepared=prepared,
                                       group=group)

    return run


def split_points_for_blocks(pc, n_block: int):
    """Reshape the point axis of a cloud, or of a tensor with the point
    axis first (per-point covariances), into [n_block, N / n_block]
    shards."""
    n = pc.shape[0] if isinstance(pc, torch.Tensor) else pc.capacity
    if n % n_block:
        raise ValueError(f"capacity {n} not divisible by {n_block} blocks")
    return mesh_lib.map_tensors(
        lambda x: x.reshape(n_block, n // n_block, *x.shape[1:]), pc)
