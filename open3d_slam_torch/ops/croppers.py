"""Cropping volumes: mask-based point filters applied at a pose.

Port of ``open3d_slam_tpu.ops.croppers`` (reference ``croppers.cpp:23-242``):
MaxRadius / MinRadius / MinMaxRadius / Cylinder volumes plus the
ColorRangeCropper.  Croppers return boolean masks over a fixed-capacity
cloud.  Radius tests are centred on the pose translation; the Cylinder z
test is ABSOLUTE in the cloud's frame (``croppers.cpp:163-165``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from open3d_slam_torch.utils.device import to_device
from open3d_slam_torch.utils.pointcloud import PointCloud

_BIG = 1e30


@dataclasses.dataclass(frozen=True)
class CroppingVolume:
    """Unified min/max radius + cylinder cropper (float32 bounds)."""

    min_radius: float = 0.0
    max_radius: float = _BIG
    min_z: float = -_BIG
    max_z: float = _BIG
    is_cylinder: bool = False

    def _f32(self, v: float, like: torch.Tensor) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=like.device)

    def is_inside(self, points: torch.Tensor,
                  pose_translation: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Boolean mask of points inside the volume centred at the pose."""
        d = points if pose_translation is None else points - pose_translation[None, :]
        if self.is_cylinder:
            r = torch.linalg.norm(d[:, :2], dim=-1)
            ok_z = ((points[:, 2] >= self._f32(self.min_z, points)) &
                    (points[:, 2] <= self._f32(self.max_z, points)))
        else:
            r = torch.linalg.norm(d, dim=-1)
            ok_z = True
        return ((r >= self._f32(self.min_radius, r)) &
                (r <= self._f32(self.max_radius, r)) & ok_z)

    def crop(self, pc: PointCloud,
             pose_translation: Optional[torch.Tensor] = None) -> PointCloud:
        return pc.with_(mask=pc.mask & self.is_inside(pc.points, pose_translation))


@dataclasses.dataclass(frozen=True)
class ColorRangeCropper:
    """Keep points whose RGB lies inside [rgb_min, rgb_max] per channel;
    colourless clouds pass through unchanged (``croppers.cpp:176-242``)."""

    rgb_min: tuple = (0.0, 0.0, 0.0)
    rgb_max: tuple = (1.0, 1.0, 1.0)

    def is_valid_color(self, colors: torch.Tensor) -> torch.Tensor:
        # to_device: a plain copy of a host list to the card would wait for
        # the queued work.
        lo = to_device(self.rgb_min, colors.device)
        hi = to_device(self.rgb_max, colors.device)
        return torch.all((colors >= lo[None, :]) & (colors <= hi[None, :]), dim=-1)

    def crop(self, pc: PointCloud) -> PointCloud:
        if pc.colors is None:
            return pc
        return pc.with_(mask=pc.mask & self.is_valid_color(pc.colors))


def max_radius(radius) -> CroppingVolume:
    return CroppingVolume(max_radius=float(radius))


def min_radius(radius) -> CroppingVolume:
    return CroppingVolume(min_radius=float(radius))


def min_max_radius(rmin, rmax) -> CroppingVolume:
    return CroppingVolume(min_radius=float(rmin), max_radius=float(rmax))


def cylinder(radius, min_z=-_BIG, max_z=_BIG) -> CroppingVolume:
    """``CylinderCroppingVolume(radius, minZ, maxZ)`` (croppers.cpp:161)."""
    return CroppingVolume(max_radius=float(radius), min_z=float(min_z),
                          max_z=float(max_z), is_cylinder=True)


def from_params(cropper_name: str, cropping_radius_max, cropping_radius_min,
                cropping_min_z=-_BIG, cropping_max_z=_BIG) -> CroppingVolume:
    """Factory mirroring ``croppers.cpp:26-48`` name dispatch."""
    if cropper_name == "MaxRadius":
        return max_radius(cropping_radius_max)
    if cropper_name == "MinRadius":
        return min_radius(cropping_radius_min)
    if cropper_name == "MinMaxRadius":
        return min_max_radius(cropping_radius_min, cropping_radius_max)
    if cropper_name == "Cylinder":
        return cylinder(cropping_radius_max, cropping_min_z, cropping_max_z)
    raise ValueError(f"unknown cropper {cropper_name!r}")


def from_cropper_params(c) -> CroppingVolume:
    """Build from a ``ScanCroppingParameters`` dataclass, wiring every field."""
    return from_params(c.cropper_name, c.cropping_max_radius,
                       c.cropping_min_radius, c.cropping_min_z, c.cropping_max_z)
