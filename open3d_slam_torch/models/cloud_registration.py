"""Cloud-registration strategy: the polymorphic ICP dispatch.

Port of ``open3d_slam_tpu.models.cloud_registration`` (reference
``CloudRegistration.cpp:16-100``): PointToPlaneIcp (kernel K4),
PointToPointIcp (correspondences through kernel K3) and GeneralizedIcp
(kernel K1), each with its normal/covariance policy
(``estimateNormalsOrCovariancesIfNeeded``) and its registration call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from open3d_slam_torch.ops import cuda_gicp, cuda_icp, hashgrid, nn_layout, registration
from open3d_slam_torch.ops import normals as normals_ops
from open3d_slam_torch.ops.hashgrid import INT32_MAX, HashGrid
from open3d_slam_torch.utils.config import CloudRegistrationParameters, IcpParameters
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry


class PreparedCloud(NamedTuple):
    """A cloud readied as a registration target: grid + per-point data in
    grid order."""
    cloud: PointCloud
    grid: HashGrid
    covs_sorted: Optional[torch.Tensor] = None  # GICP only
    # K1's or K4's target arrays and sweep layout (their ``prepare_target``)
    kernel_target: Optional[tuple] = None

    def nearest_layout(self) -> nn_layout.TargetLayout:
        """K3's target layout of ``grid``: the kernel target's, which
        ``_prepare_target_fn`` makes from the grid's own points and mask,
        or a new one."""
        return hashgrid.nearest_layout(
            self.grid, None if self.kernel_target is None else self.kernel_target[-1])


@telemetry.staged("target_prep")
def _prepare_target_fn(pc: PointCloud, cell: float, with_covs: bool,
                       with_kernel_target: bool = False) -> PreparedCloud:
    """Identity-order target: the fused kernel needs only the validity
    marker (``identity_order=True`` of the JAX function).  With
    ``with_kernel_target``, the target arrays and sweep layout of K1 (with
    ``with_covs``) or K4, made once here: they serve every registration
    against this target, and the layout's Morton order serves as the query
    order when the cloud is registered as a source."""
    n = pc.capacity
    grid = HashGrid(
        hashes_sorted=torch.where(pc.mask, torch.zeros((), dtype=torch.int32,
                                                        device=pc.device),
                                  torch.full((), INT32_MAX, dtype=torch.int32,
                                             device=pc.device)),
        points_sorted=pc.points, normals_sorted=pc.normals,
        order=torch.arange(n, dtype=torch.int32, device=pc.device),
        cell_size=float(cell))
    covs = normals_ops.covariances_from_normals(pc) if with_covs else None
    kernel_target = None
    if with_kernel_target:
        kernel_target = (cuda_gicp.prepare_target(pc.points, covs, pc.mask) if with_covs
                         else cuda_icp.prepare_target(pc.points, pc.normals, pc.mask))
    return PreparedCloud(cloud=pc, grid=grid, covs_sorted=covs,
                         kernel_target=kernel_target)


class CloudRegistrationStrategy:
    """One of PointToPlaneIcp | PointToPointIcp | GeneralizedIcp."""

    def __init__(self, reg_type: str, icp: IcpParameters):
        if reg_type not in ("PointToPlaneIcp", "PointToPointIcp", "GeneralizedIcp"):
            raise ValueError(f"unknown registration type {reg_type!r}")
        self.reg_type = reg_type
        self.icp = icp

    def needs_normals(self) -> bool:
        return self.reg_type in ("PointToPlaneIcp", "GeneralizedIcp")

    def needs_kernel_target(self) -> bool:
        """Whether the registration sweeps with K1 or K4 (the other types
        find correspondences through K3)."""
        return self.reg_type in ("PointToPlaneIcp", "GeneralizedIcp")

    def estimate_normals_if_needed(self, pc: PointCloud,
                                   sensor_position: Optional[torch.Tensor] = None
                                   ) -> PointCloud:
        """Hybrid-KNN PCA normals oriented toward the sensor
        (``KDTreeSearchParamHybrid(maxDistanceKnn_, knn_)``), when the type
        needs them."""
        if not self.needs_normals():
            return pc
        return normals_ops.estimate_normals(
            pc, radius=self.icp.max_distance_knn, max_nn=self.icp.knn,
            orientation_reference=sensor_position)

    def prepare_target(self, pc: PointCloud) -> PreparedCloud:
        cell = max(self.icp.max_correspondence_distance, 1e-6)
        return _prepare_target_fn(pc, cell, with_covs=self.reg_type == "GeneralizedIcp",
                                  with_kernel_target=self.needs_kernel_target())

    @telemetry.staged("register")
    def register(self, source: PointCloud, target: PreparedCloud,
                 init: torch.Tensor, source_order: Optional[torch.Tensor] = None
                 ) -> registration.RegistrationResult:
        """Register ``source`` against ``target``; ``source_order`` is the
        source's Morton order when the caller has it (the layout order of
        the same cloud prepared as an earlier target).  The kernel reads
        ``target.kernel_target`` where it is made."""
        if self.reg_type == "PointToPlaneIcp":
            return registration.icp_point_to_plane(
                source, target.grid, init, self.icp.max_correspondence_distance,
                max_iterations=self.icp.max_num_iter, prepared=target.kernel_target,
                source_order=source_order)
        if self.reg_type == "PointToPointIcp":
            return registration.icp_point_to_point(
                source, target.grid, init, self.icp.max_correspondence_distance,
                max_iterations=self.icp.max_num_iter)
        source_covs = normals_ops.covariances_from_normals(source)
        return registration.icp_generalized(
            source, source_covs, target.grid, target.covs_sorted, init,
            self.icp.max_correspondence_distance,
            max_iterations=self.icp.max_num_iter, prepared=target.kernel_target,
            source_order=source_order)


def cloud_registration_factory(p: CloudRegistrationParameters) -> CloudRegistrationStrategy:
    """Mirror of ``cloudRegistrationFactory`` (``CloudRegistration.cpp:85-100``)."""
    return CloudRegistrationStrategy(p.reg_type, p.icp)
