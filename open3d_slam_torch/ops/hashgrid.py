"""Registration-target container of ``open3d_slam_tpu.ops.hashgrid``.

Only the ``HashGrid`` record is ported in this slice: the port's registration
runs the fused brute-force kernel on every device, which needs the target
points and a validity marker (``hashes_sorted != INT32_MAX``) in identity
order, never a hash probe.  The grid build and the 27-cell queries belong to
the loop-closure slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class HashGrid:
    """Target points in grid order with their validity keys."""

    hashes_sorted: torch.Tensor            # (N,) int32; INT32_MAX for invalid
    points_sorted: torch.Tensor            # (N, 3) float32
    normals_sorted: Optional[torch.Tensor]  # (N, 3) float32 or None
    order: torch.Tensor                    # (N,) int32 original index per slot
    cell_size: float

    @property
    def capacity(self) -> int:
        return self.hashes_sorted.shape[0]
