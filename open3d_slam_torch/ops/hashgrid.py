"""Spatial hash grid and brute-force neighbour queries.

Port of ``open3d_slam_tpu.ops.hashgrid`` on its kernel path: ``build`` (hash
sort) and ``build_batched`` (one grid per batch element, ``jax.vmap(build)``),
``query_nearest`` with the caller semantics of the JAX package's
``_query_nearest_pallas`` (nearest valid point through kernel K3, then the
winner's exact d2, the distance gate and validity; on the card K3 takes the
gate and skips exactly what cannot pass it), ``nearest_layout`` (K3's target
layout of a grid, once per grid), and
``query_radius_bruteforce`` (exact hybrid radius + k).  The JAX package's
27-cell probe routes (``_query_nearest_probe``, ``query_radius``), its CPU
paths, are not ported: the port takes the brute-force routes on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from open3d_slam_torch.ops import cuda_knn, nn_layout
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


def build_batched(pc: PointCloud, cell_size: float) -> HashGrid:
    """One grid per element of a batched cloud (points (B, N, 3), mask
    (B, N)), stacked on a leading axis: ``build`` of each element, as
    ``jax.vmap(hashgrid.build)`` gives it."""
    grids = [build(PointCloud(points=pc.points[b], mask=pc.mask[b],
                              normals=None if pc.normals is None else pc.normals[b]),
                   cell_size) for b in range(pc.points.shape[0])]

    def stack(name):
        return (None if getattr(grids[0], name) is None
                else torch.stack([getattr(g, name) for g in grids]))

    return HashGrid(hashes_sorted=stack("hashes_sorted"), points_sorted=stack("points_sorted"),
                    normals_sorted=stack("normals_sorted"), order=stack("order"),
                    cell_size=float(cell_size))


def nearest_layout(grid: HashGrid, target: Optional[nn_layout.TargetLayout] = None
                   ) -> nn_layout.TargetLayout:
    """Kernel K3's target layout of ``grid``, bound to its points and hashes:
    ``target``, a Morton layout the caller made from the grid's own points
    and validity (K1's or K4's ``prepare_target`` of the same cloud), or one
    made here."""
    if target is None:
        target = nn_layout.target_layout(grid.points_sorted, grid.hashes_sorted != INT32_MAX)
    return nn_layout.bind(target, grid.points_sorted, grid.hashes_sorted)


def query_nearest(grid: HashGrid, query_points: torch.Tensor, max_dist,
                  layout: Optional[nn_layout.TargetLayout] = None,
                  query_order: Optional[torch.Tensor] = None,
                  query_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest valid grid point within ``max_dist`` of each query.

    query_points (M, 3) or (B, M, 3).  K3 finds the nearest valid point in
    the expansion form; its exact d2 is then recomputed and gated at
    ``max_dist``.  On the card the kernel takes the gate and skips, exactly,
    the target tiles that cannot hold a winner within it, so the result is
    that of a sweep over every pair.  It reads ``layout``
    (``nearest_layout(grid)``) and ``query_order``, the (M,) Morton order of
    the queries or of the untransformed source they were moved from
    (``nn_layout.query_order``), each made here when not given.  On the CPU
    the plain version sweeps every pair.  A query outside ``query_mask``
    ((M,) or (B, M) bool) is not found.

    Returns (index into the sorted arrays, squared distance, found), shaped
    like the queries' leading dims; a query with no point in range gets
    index 0, d2 +inf and found False."""
    n = grid.capacity
    pts = grid.points_sorted
    valid = grid.hashes_sorted != INT32_MAX
    lead = query_points.shape[:-1]
    q = query_points.reshape(-1, lead[-1], 3)
    if layout is not None:
        nn_layout.check_bound(layout, pts, grid.hashes_sorted)
    if pts.device.type == "cuda":
        if layout is None:
            layout = nearest_layout(grid)
        if query_order is None:
            qv = (torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
                  if query_mask is None else query_mask.expand(q.shape[:2]))
            query_order = nn_layout.query_order(q, qv)
        best_idx, best_e = cuda_knn.nn_argmin_within(
            q.contiguous(), query_mask, nn_layout.SweepLayout(layout, query_order), max_dist)
    else:
        t2 = torch.where(valid, cuda_knn.squared_norms(pts),
                         torch.full((), float("inf"), dtype=torch.float32, device=pts.device))
        best_idx, best_e = cuda_knn.nn_argmin(q.reshape(-1, 3), pts.t(), t2)
    best_idx = torch.clamp(best_idx.reshape(-1).long(), 0, n - 1)
    found, best_d2 = gate(pts, valid, q.reshape(-1, 3), best_idx, best_e.reshape(-1), max_dist)
    if query_mask is not None:
        found = found & query_mask.expand(q.shape[:2]).reshape(-1)
    return (torch.where(found, best_idx, torch.zeros_like(best_idx)).to(torch.int32).reshape(lead),
            torch.where(found, best_d2, torch.full_like(best_d2, float("inf"))).reshape(lead),
            found.reshape(lead))


def gate(points: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor,
         idx: torch.Tensor, e: torch.Tensor, max_dist
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The verdict ``query_nearest`` gives K3's winners: (found, exact d2),
    shaped like ``idx``, of queries (..., 3) whose winners among ``points``
    (N, 3) are ``idx`` (..., indices in range) with expansion-form ``e``:
    found when e is finite, the winner valid and its exact d2 within
    ``max_dist``."""
    i = idx.reshape(-1).long()
    d2 = ((points[i] - queries.reshape(-1, 3)) ** 2).sum(dim=-1)
    md = torch.tensor(float(max_dist), dtype=torch.float32, device=points.device)
    found = torch.isfinite(e.reshape(-1)) & (d2 <= md * md) & valid[i]
    return found.reshape(idx.shape), d2.reshape(idx.shape)


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
