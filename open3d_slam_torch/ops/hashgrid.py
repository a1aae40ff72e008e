"""Spatial hash grid and brute-force neighbour queries.

Port of ``open3d_slam_tpu.ops.hashgrid`` on its kernel path: ``build`` (hash
sort), ``query_nearest`` with the caller semantics of the JAX package's
``_query_nearest_pallas`` (nearest valid point through kernel K3, then the
winner's exact d2, the distance gate and validity), and
``query_radius_bruteforce`` (exact hybrid radius + k).  The JAX package's
27-cell probe routes (``_query_nearest_probe``, ``query_radius``), its CPU
paths, are not ported: the port takes the brute-force routes on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from open3d_slam_torch.ops import cuda_knn
from open3d_slam_torch.ops.voxel import hash_coords
from open3d_slam_torch.utils.pointcloud import PointCloud

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


def build(pc: PointCloud, cell_size: float) -> HashGrid:
    """Grid over the valid points of ``pc``: cell hashes sorted with a
    stable sort, as ``jnp.argsort`` sorts."""
    cell = torch.tensor(float(cell_size), dtype=torch.float32, device=pc.device)
    coords = torch.floor(pc.points / cell).to(torch.int32)
    h = torch.where(pc.mask, hash_coords(coords),
                    torch.full((), INT32_MAX, dtype=torch.int32, device=pc.device))
    order = torch.argsort(h, stable=True)
    return HashGrid(hashes_sorted=h[order], points_sorted=pc.points[order],
                    normals_sorted=None if pc.normals is None else pc.normals[order],
                    order=order.to(torch.int32), cell_size=float(cell_size))


def query_nearest(grid: HashGrid, query_points: torch.Tensor, max_dist
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest valid grid point within ``max_dist`` of each query.

    Returns (index into the sorted arrays, squared distance, found); a query
    with no point in range gets index 0, d2 +inf and found False."""
    n = grid.capacity
    pts = grid.points_sorted
    valid = grid.hashes_sorted != INT32_MAX
    t2 = torch.where(valid, cuda_knn.squared_norms(pts),
                     torch.full((), float("inf"), dtype=torch.float32, device=pts.device))
    best_idx, _ = cuda_knn.nn_argmin(query_points, pts.t(), t2)
    best_idx = torch.clamp(best_idx.long(), 0, n - 1)
    best_d2 = ((pts[best_idx] - query_points) ** 2).sum(dim=-1)
    md = torch.tensor(float(max_dist), dtype=torch.float32, device=pts.device)
    found = (best_d2 <= md * md) & valid[best_idx]
    return (torch.where(found, best_idx, torch.zeros_like(best_idx)).to(torch.int32),
            torch.where(found, best_d2, torch.full_like(best_d2, float("inf"))),
            found)


def query_radius_bruteforce(grid: HashGrid, query_points: torch.Tensor, radius,
                            max_neighbors: int = 32, chunk: int = 256
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact hybrid radius + k search: up to ``max_neighbors`` nearest valid
    grid points within ``radius``, nearest first, from a chunked full-float32
    distance matrix and ``torch.topk`` (``lax.top_k`` in the JAX package).
    Returns (indices (M, K) int32, sq_dists (M, K), valid (M, K))."""
    n = grid.capacity
    k = min(max_neighbors, n)
    t = grid.points_sorted
    valid_t = grid.hashes_sorted != INT32_MAX
    t2 = torch.where(valid_t, (t * t).sum(dim=1),
                     torch.full((), float("inf"), dtype=torch.float32, device=t.device))
    r = torch.tensor(float(radius), dtype=torch.float32, device=t.device)
    r2 = r * r
    tt = t.t().contiguous()
    idx, d2s, valids = [], [], []
    for s in range(0, query_points.shape[0], chunk):
        q = query_points[s:s + chunk]
        d2 = (q * q).sum(dim=1)[:, None] + t2[None, :] - 2.0 * (q @ tt)
        topi = torch.topk(-d2, k, dim=1).indices
        sel_d2 = ((t[topi] - q[:, None, :]) ** 2).sum(dim=-1)
        idx.append(topi.to(torch.int32))
        d2s.append(sel_d2)
        valids.append((sel_d2 <= r2) & valid_t[topi])
    return torch.cat(idx), torch.cat(d2s), torch.cat(valids)
