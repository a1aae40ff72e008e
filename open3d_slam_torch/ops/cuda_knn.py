"""Nearest valid target in the expansion form: kernel K3 and its plain version.

Port of ``open3d_slam_tpu.ops.pallas_knn``.  Both entries below run the
hand-written kernel in ``csrc/knn.cu`` on CUDA tensors, and the same function
in plain PyTorch on CPU tensors: per query, the running (min, argmin) over
the valid targets of the expansion form e = (|q|^2 + |t|^2) - 2 q.t, rounded
operation by operation in the JAX operand order, ties to the lowest target
index, (0, +inf) for a query with no valid target.

- ``nn_argmin`` keeps the JAX kernel's signature: every pair is swept.
- ``nn_argmin_within`` is the entry the callers use, through
  ``ops/hashgrid.query_nearest``, which holds the winner's exact d2 to a gate
  r.  It takes queries (B, M, 3) with a mask, the target as a Morton layout
  (``nn_layout``, made once per grid) with the queries' order, and r, and
  the kernel skips every (query group, target tile) pair that cannot hold a
  winner within r, exactly (the argument is in ``csrc/knn.cu``).  For every
  query with a valid target within r the result is the full sweep's (index,
  e), bit for bit; any other query gets (0, +inf), or a winner whose exact
  d2 exceeds r, which the callers' gate rejects.  So the callers' ``found``,
  and the index wherever it holds, are the full sweep's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from open3d_slam_torch.ops import cuda_build, nn_layout

_PLAIN_CHUNK = 512


def squared_norms(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 per row of (K, 3), summed in a fixed order (x, then y, then z)."""
    return p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]


def nn_argmin_plain(query_points: torch.Tensor, q2: torch.Tensor,
                    target_points_t: torch.Tensor, target_sq_masked: torch.Tensor):
    """Plain PyTorch version of the kernel, chunked over queries (at
    32768 x 65536 the full matrix is 8.6 GB).  Elementwise operations only:
    a matmul would sum the dot product in another order.  torch.argmin
    returns the first minimum.  Returns (idx (M,) int32, d2 (M,) float32)."""
    tx, ty, tz = target_points_t[0][None, :], target_points_t[1][None, :], \
        target_points_t[2][None, :]
    t2 = target_sq_masked[None, :]
    idx, best = [], []
    for s in range(0, query_points.shape[0], _PLAIN_CHUNK):
        q = query_points[s:s + _PLAIN_CHUNK]
        dot = q[:, 0:1] * tx + q[:, 1:2] * ty + q[:, 2:3] * tz
        d2 = (q2[s:s + _PLAIN_CHUNK, None] + t2) - 2.0 * dot
        a = torch.argmin(d2, dim=1)
        idx.append(a.to(torch.int32))
        best.append(torch.gather(d2, 1, a[:, None])[:, 0])
    return torch.cat(idx), torch.cat(best)


def knn_inputs(query_points: torch.Tensor, target_points_t: torch.Tensor,
               target_sq_masked: torch.Tensor):
    """What the plain version reads: contiguous float32 queries (M, 3),
    their |q|^2 (M,) (computed here, as the JAX wrapper computes it around
    its Pallas call), transposed targets (3, N) and masked |t|^2 (N,)."""
    q = query_points.to(torch.float32).contiguous()
    return (q, squared_norms(q).contiguous(),
            target_points_t.to(torch.float32).contiguous(),
            target_sq_masked.reshape(-1).to(torch.float32).contiguous())


def layout_targets(target: nn_layout.TargetLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points (N, 3), valid (N,)) in index order, read back from a target
    layout (invalid points at 0)."""
    n = target.order.shape[-1]
    xyz = target.pts[:n, :3]
    ok = xyz[:, 0] != nn_layout.SENTINEL
    idx = target.order.long()
    points = torch.zeros_like(xyz).index_copy_(0, idx, torch.where(ok[:, None], xyz, 0.0))
    return points, torch.zeros_like(ok).index_copy_(0, idx, ok)


def nn_argmin_within_plain(queries: torch.Tensor, query_mask: Optional[torch.Tensor],
                           layout: nn_layout.SweepLayout, r=None):
    """Plain version of ``nn_argmin_within``: the full sweep over the
    layout's targets (``r`` and the query order are accepted and ignored:
    the kernel's skip is exact), (0, +inf) for a query outside
    ``query_mask``.  Returns (idx (B, M) int32, e (B, M) float32)."""
    b, m, _ = queries.shape
    points, valid = layout_targets(layout.target)
    t2 = torch.where(valid, squared_norms(points), float("inf"))
    idx, e = nn_argmin_plain(*knn_inputs(queries.reshape(-1, 3), points.t(), t2))
    idx, e = idx.reshape(b, m), e.reshape(b, m)
    if query_mask is not None:
        keep = query_mask.reshape(-1, m).expand(b, m)
        idx = torch.where(keep, idx, 0)
        e = torch.where(keep, e, float("inf"))
    return idx, e


def _squared(r) -> float:
    """r^2 rounded as the callers' float32 ``r * r``."""
    r32 = np.float32(r)
    return float(r32 * r32)


def _launch_knn(queries: torch.Tensor, query_mask: Optional[torch.Tensor],
                layout: nn_layout.SweepLayout, r2: float):
    lib = cuda_build.load("knn")
    fn = lib.knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] +
                   [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float] +
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    if (lib.knn_tile_size(), lib.knn_group_size()) != (nn_layout.TILE, nn_layout.GROUP):
        raise RuntimeError("csrc/knn.cu and ops/nn_layout.py disagree on the tile or "
                           "group size")
    b, m, _ = queries.shape
    dev = queries.device
    t_pts, t_boxes = layout.target.pts, layout.target.boxes
    n_tiles = t_boxes.shape[0]
    splits = nn_layout.plan_splits(-(-m // nn_layout.GROUP), b, n_tiles, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys, _ = nn_layout.scratch(dev, stream, b, m)
    out = torch.empty((2, b, m), dtype=torch.int32, device=dev)
    order = layout.query_order
    err = fn(queries.data_ptr(), 0 if query_mask is None else query_mask.data_ptr(),
             int(query_mask is not None and query_mask.dim() == 2),
             order.data_ptr(), int(order.dim() == 2), t_pts.data_ptr(), t_boxes.data_ptr(),
             n_tiles, r2, keys.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), b, m,
             splits, stream)
    cuda_build.check(err, "nn_argmin")
    return out[0], out[1].view(torch.float32)


def nn_argmin_within(queries: torch.Tensor, query_mask: Optional[torch.Tensor],
                     layout: nn_layout.SweepLayout, r):
    """Per query, the argmin of the expansion form over the layout's valid
    targets, for every query whose nearest valid target lies within ``r``
    (see the module docstring for the others).

    queries (B, M, 3) float32; query_mask None (all valid), (M,) or (B, M)
    bool: a query outside it gets (0, +inf); layout the targets' Morton
    layout (``nn_layout.target_layout``) and the queries' order (M,) or (B,
    M) int32 (``nn_layout.query_order`` of the queries, or of the
    untransformed source they were moved from); r a float (+inf: every pair
    is swept).  Returns (idx (B, M) int32 into the targets, e (B, M)
    float32)."""
    dev = queries.device
    if dev.type == "cpu":
        return nn_argmin_within_plain(queries, query_mask, layout, r)
    if dev.type != "cuda":
        raise RuntimeError(f"nn_argmin_within: no kernel for device {dev}")
    if queries.dim() != 3 or queries.shape[-1] != 3 or queries.shape[0] > 65535:
        raise ValueError("nn_argmin_within: queries must be (B, M, 3), B <= 65535")
    b, m, _ = queries.shape
    if (queries.dtype != torch.float32 or not queries.is_contiguous()
            or (query_mask is not None
                and (query_mask.dtype != torch.bool or not query_mask.is_contiguous()
                     or query_mask.device != dev
                     or tuple(query_mask.shape) not in ((m,), (b, m))))):
        raise ValueError(f"nn_argmin_within: queries contiguous float32 (B, M, 3) and a "
                         f"contiguous bool mask (M,) or (B, M), all on {dev}")
    n = layout.target.order.shape[-1]
    nn_layout.check_fit(layout, b, m, n, dev)
    cuda_build.count_launch("nn_argmin_within", (b, m, n))
    return _launch_knn(queries, query_mask, layout, _squared(r))


def nn_argmin(query_points: torch.Tensor, target_points_t: torch.Tensor,
              target_sq_masked: torch.Tensor):
    """Running argmin of squared distances (the JAX kernel's signature,
    without its block-size constraints).

    query_points (M, 3); target_points_t (3, N), transposed; target_sq_masked
    (N,) or (1, N): |t|^2 (``squared_norms``) with +inf at invalid slots.
    The kernel recomputes |t|^2 from the coordinates and reads only which
    targets are valid; it sweeps every pair, on a layout made here.  Returns
    (best_idx (M,) int32, best_d2_approx (M,) float32)."""
    dev = query_points.device
    inputs = knn_inputs(query_points, target_points_t, target_sq_masked)
    if dev.type == "cpu":
        return nn_argmin_plain(*inputs)
    if dev.type != "cuda":
        raise RuntimeError(f"nn_argmin: no kernel for device {dev}")
    for t in inputs:
        if t.device != dev:
            raise ValueError(f"nn_argmin: every input must lie on {dev}")
    q, _, t_t, t2 = inputs
    if t_t.shape[0] != 3 or t2.shape[0] != t_t.shape[1]:
        raise ValueError("nn_argmin: targets must be (3, N) with (N,) norms")
    m, n = q.shape[0], t_t.shape[1]
    target = nn_layout.target_layout(t_t.t(), t2 < float("inf"))
    order = torch.arange(m, dtype=torch.int32, device=dev)
    cuda_build.count_launch("nn_argmin", (m, n))
    idx, e = _launch_knn(q[None], None, nn_layout.SweepLayout(target, order), float("inf"))
    return idx[0], e[0]
