"""Cloud-registration strategy: the polymorphic ICP dispatch.

Port of ``open3d_slam_tpu.models.cloud_registration`` (reference
``CloudRegistration.cpp:16-100``).  GeneralizedIcp — the registration of
both the scan-to-scan and the scan-to-map stages in every shipped
configuration — is ported; PointToPlaneIcp and PointToPointIcp come with the
localization slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from open3d_slam_torch.ops import normals as normals_ops, registration
from open3d_slam_torch.ops.hashgrid import INT32_MAX, HashGrid
from open3d_slam_torch.utils.config import CloudRegistrationParameters, IcpParameters
from open3d_slam_torch.utils.pointcloud import PointCloud

_LATER = ("{} is not ported yet: it arrives with the localization slice of "
          "the port (see ROADMAP.md); use GeneralizedIcp")


class PreparedCloud(NamedTuple):
    """A cloud readied as a registration target: grid + per-point data in
    grid order."""
    cloud: PointCloud
    grid: HashGrid
    covs_sorted: Optional[torch.Tensor] = None  # GICP only


def _prepare_target_fn(pc: PointCloud, cell: float, with_covs: bool) -> PreparedCloud:
    """Identity-order target: the fused kernel needs only the validity
    marker, and the packed-voxel order of the input keeps the target tiles
    spatially compact for the AABB tile skip (``identity_order=True`` of the
    JAX function)."""
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
    return PreparedCloud(cloud=pc, grid=grid, covs_sorted=covs)


class CloudRegistrationStrategy:
    """One of PointToPlaneIcp | PointToPointIcp | GeneralizedIcp."""

    def __init__(self, reg_type: str, icp: IcpParameters):
        if reg_type not in ("PointToPlaneIcp", "PointToPointIcp", "GeneralizedIcp"):
            raise ValueError(f"unknown registration type {reg_type!r}")
        if reg_type != "GeneralizedIcp":
            raise NotImplementedError(_LATER.format(reg_type))
        self.reg_type = reg_type
        self.icp = icp

    def needs_normals(self) -> bool:
        return True

    def prepare_target(self, pc: PointCloud) -> PreparedCloud:
        cell = max(self.icp.max_correspondence_distance, 1e-6)
        return _prepare_target_fn(pc, cell, with_covs=True)

    def register(self, source: PointCloud, target: PreparedCloud,
                 init: torch.Tensor) -> registration.RegistrationResult:
        source_covs = normals_ops.covariances_from_normals(source)
        return registration.icp_generalized(
            source, source_covs, target.grid, target.covs_sorted, init,
            self.icp.max_correspondence_distance,
            max_iterations=self.icp.max_num_iter)


def cloud_registration_factory(p: CloudRegistrationParameters) -> CloudRegistrationStrategy:
    """Mirror of ``cloudRegistrationFactory`` (``CloudRegistration.cpp:85-100``)."""
    return CloudRegistrationStrategy(p.reg_type, p.icp)
