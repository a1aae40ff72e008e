"""Padded, masked point cloud — the port of ``open3d_slam_tpu.utils.pointcloud``.

Every cloud is a fixed-capacity set of tensors plus a validity mask, as in
the JAX package: capacities stay static so every kernel sees the shapes the
configuration names, and filtering toggles mask bits or compacts by gather.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from open3d_slam_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud.

    Attributes:
      points:  (N, 3) float32; garbage beyond ``mask``.
      mask:    (N,) bool — True for valid points.
      normals: (N, 3) float32 or None.
      colors:  (N, 3) float32 or None.
    """

    points: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def has_normals(self) -> bool:
        return self.normals is not None

    def has_colors(self) -> bool:
        return self.colors is not None

    def with_(self, **kw) -> "PointCloud":
        return dataclasses.replace(self, **kw)

    def masked_points(self, fill: float = 1e9) -> torch.Tensor:
        """Points with invalid rows moved to a far sentinel, so that they
        never take part in neighbour queries."""
        return torch.where(self.mask[:, None], self.points,
                           torch.full((), fill, dtype=self.points.dtype, device=self.device))


def from_numpy(points: np.ndarray, capacity: Optional[int] = None,
               normals: Optional[np.ndarray] = None,
               colors: Optional[np.ndarray] = None,
               device="cpu") -> PointCloud:
    """Padded PointCloud from (n, 3) numpy points (capacity defaults to the
    next power of two >= n)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if capacity is None:
        capacity = max(8, 1 << (n - 1).bit_length())
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    pad = capacity - n

    def _pad(a):
        if a is None:
            return None
        a = np.asarray(a, dtype=np.float32)
        a = np.concatenate([a, np.zeros((pad, 3), np.float32)], axis=0)
        return to_device(a, device)

    mask = to_device(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
                     device, dtype=torch.bool)
    return PointCloud(points=_pad(points), mask=mask, normals=_pad(normals),
                      colors=_pad(colors))


def to_numpy(pc: PointCloud):
    """Valid points (and normals/colors) as numpy arrays."""
    mask = pc.mask.cpu().numpy()
    out = {"points": pc.points.cpu().numpy()[mask]}
    if pc.normals is not None:
        out["normals"] = pc.normals.cpu().numpy()[mask]
    if pc.colors is not None:
        out["colors"] = pc.colors.cpu().numpy()[mask]
    return out


def empty(capacity: int, with_normals: bool = False, with_colors: bool = False,
          device="cpu") -> PointCloud:
    z = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    return PointCloud(points=z, mask=torch.zeros(capacity, dtype=torch.bool,
                                                 device=device),
                      normals=z if with_normals else None,
                      colors=z if with_colors else None)


def compact(pc: PointCloud) -> PointCloud:
    """Valid points moved to the front, in stable order; same capacity."""
    order = torch.argsort((~pc.mask).to(torch.int32), stable=True)

    def take(a):
        return None if a is None else a[order]

    return PointCloud(points=take(pc.points), mask=pc.mask[order],
                      normals=take(pc.normals), colors=take(pc.colors))


def padded_capacity(n: int, multiple: int = 256) -> int:
    """Smallest multiple of ``multiple`` >= n."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def compact_to(pc: PointCloud, out_capacity: int) -> PointCloud:
    """Gather valid points into a NEW capacity, valid-first, STABLE order.

    If the valid count exceeds ``out_capacity``, a uniform stride of the valid
    points is kept (spatially unbiased, same policy as the voxel-merge
    overflow).  The stride is computed in float32 as the JAX package does, so
    both keep the same rows."""
    n = pc.capacity
    dev = pc.device
    order = torch.argsort((~pc.mask).to(torch.int32), stable=True)
    total = pc.mask.sum(dtype=torch.int32)
    idx = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    stride = total.to(torch.float32) / float(out_capacity)
    strided = torch.floor(idx.to(torch.float32) * stride).to(torch.int32)
    want = torch.where(total > out_capacity, strided, idx)
    pos = order[torch.clamp(want, max=n - 1).long()]
    mask = idx < torch.clamp(total, max=out_capacity)

    def take(a):
        return None if a is None else a[pos]

    return PointCloud(points=take(pc.points), mask=mask,
                      normals=take(pc.normals), colors=take(pc.colors))


def concat(a: PointCloud, b: PointCloud, capacity: int) -> PointCloud:
    """Valid points of ``a``, then those of ``b``, in a new cloud of
    ``capacity`` (overflow keeps a uniform stride, as ``compact_to``).  A
    channel one side lacks is zero there."""
    def cat(x, y):
        if x is None and y is None:
            return None
        x = torch.zeros_like(a.points) if x is None else x
        y = torch.zeros_like(b.points) if y is None else y
        return torch.cat([x, y], dim=0)

    big = PointCloud(points=cat(a.points, b.points), mask=torch.cat([a.mask, b.mask]),
                     normals=cat(a.normals, b.normals), colors=cat(a.colors, b.colors))
    return compact_to(big, capacity)
