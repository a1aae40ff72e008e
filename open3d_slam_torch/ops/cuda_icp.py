"""Fused point-to-plane ICP normal equations: kernel K4 and what surrounds it.

Port of ``open3d_slam_tpu.ops.pallas_icp``.  ``p2l_normal_eq`` is the
counterpart of the Pallas kernel of the same name: on CUDA tensors it
launches the hand-written kernel in ``csrc/icp.cu``; on CPU tensors it runs
``p2l_normal_eq_plain``, the same function in plain PyTorch.  Output layout
(B, 8, 128): [JtJ | Jtr; Jtr^T | r^T r] in rows 0..6 and (inlier count,
inlier d2 sum) in row 7.  Target-side arrays are 2-D when one target is
shared by the whole batch (multi-start localization) and 3-D when each batch
element has its own.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from open3d_slam_torch.ops import cuda_build, nn_layout
from open3d_slam_torch.ops.cuda_gicp import plain_disagreement, unpack  # noqa: F401

_BIG = 3.0e38
# Distance entries per chunk of the plain version: cache-sized on the CPU,
# large on the card, where each chunk costs a few kernel launches.
_PLAIN_PAIRS_CPU = 1 << 20
_PLAIN_PAIRS_CARD = 1 << 25


def _nn_plain(q: torch.Tensor, t_t: torch.Tensor, tv: torch.Tensor):
    """Exact difference-form nearest valid target of each row of ``q``
    (K, 3), first index on ties; invalid targets at 3e38, as the Pallas
    kernel masks them.  Chunked over rows: at the rank stage of global
    localization a full (B, M, N) block would be 275 GB."""
    best, arg = [], []
    valid = tv.reshape(-1) > 0.0
    pairs = _PLAIN_PAIRS_CPU if q.device.type == "cpu" else _PLAIN_PAIRS_CARD
    chunk = max(1, pairs // max(t_t.shape[-1], 1))
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk]
        d0 = qc[:, 0:1] - t_t[0:1, :]
        d1 = qc[:, 1:2] - t_t[1:2, :]
        d2_ = qc[:, 2:3] - t_t[2:3, :]
        d2 = d0 * d0 + d1 * d1 + d2_ * d2_
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, _BIG))
        a = torch.argmin(d2, dim=1)
        arg.append(a)
        best.append(torch.gather(d2, 1, a[:, None])[:, 0])
    return torch.cat(best), torch.cat(arg)


def _p2l_rows(q: torch.Tensor, n: torch.Tensor, c: torch.Tensor,
              wf: torch.Tensor) -> torch.Tensor:
    """Rows G = [p x n, n, n.p - c] * wf of (K, 3) points and their
    correspondences' normals (K, 3) and offsets (K,), as (K, 7)."""
    p0, p1, p2 = q[:, 0:1], q[:, 1:2], q[:, 2:3]
    n0, n1, n2 = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    r = p0 * n0 + p1 * n1 + p2 * n2 - c[:, None]
    G = torch.cat([p1 * n2 - p2 * n1, p2 * n0 - p0 * n2, p0 * n1 - p1 * n0,
                   n0, n1, n2, r], dim=1)
    return G * wf


def p2l_normal_eq_plain(q_pts, q_mask_f, t_t, tn_t, tc, tv, r2,
                        layout=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel; ``layout`` is accepted and
    ignored (the kernel's skip is exact).  Distances in the kernel's
    elementwise order (no matmul, which would sum in another order and flip
    inliers); the Gram of each batch element as one product of its float32
    rows, summed in float64, so that the reference a kernel is held against
    carries no summation error of its own."""
    b, m, _ = q_pts.shape
    batched = t_t.dim() == 3
    out = torch.zeros((b, 8, 128), dtype=torch.float32, device=q_pts.device)
    if batched:
        parts = [_nn_plain(q_pts[i], t_t[i], tv[i]) for i in range(b)]
        best = torch.stack([p[0] for p in parts])
        arg = torch.stack([p[1] for p in parts])
        n = torch.stack([tn_t[i][:, arg[i]].t() for i in range(b)])
        c = torch.stack([tc[i].reshape(-1)[arg[i]] for i in range(b)])
    else:
        best, arg = _nn_plain(q_pts.reshape(b * m, 3), t_t, tv)
        best, arg = best.reshape(b, m), arg.reshape(b, m)
        n = tn_t.t()[arg]
        c = tc.reshape(-1)[arg]
    qm = q_mask_f.reshape(-1, m) > 0.0
    wf = ((best <= r2.reshape(())) & qm).to(torch.float32)
    G = _p2l_rows(q_pts.reshape(-1, 3), n.reshape(-1, 3), c.reshape(-1),
                  wf.reshape(-1, 1)).reshape(b, m, 7)
    G = G.double()
    out[:, 0:7, 0:7] = (G.transpose(1, 2) @ G).float()
    out[:, 7, 0] = wf.sum(dim=1)
    out[:, 7, 1] = (wf.double() * best.double()).sum(dim=1).float()
    return out


def _launch_p2l(q_pts, q_mask_f, t_t, tn_t, tc, tv, r2,
                layout: nn_layout.SweepLayout) -> torch.Tensor:
    lib = cuda_build.load("icp")
    fn = lib.p2l_normal_eq_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] +
                   [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] +
                   [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5 +
                   [ctypes.c_int] * 4 + [ctypes.c_void_p])
    b, m, _ = q_pts.shape
    n = t_t.shape[-1]
    dev = q_pts.device
    t_pts, t_boxes = layout.target.pts, layout.target.boxes
    n_tiles = t_boxes.shape[-2]
    q_blocks = -(-m // lib.p2l_block_size())
    if (lib.p2l_tile_size(), lib.p2l_group_size()) != (nn_layout.TILE, nn_layout.GROUP):
        raise RuntimeError("csrc/nn_sweep.cuh and ops/nn_layout.py disagree on the "
                           "tile or group size")
    splits = nn_layout.plan_splits(-(-m // nn_layout.GROUP), b, n_tiles, dev)
    block_part = torch.empty((b, q_blocks, 30), dtype=torch.float32, device=dev)
    out = torch.empty((b, 8, 128), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys, tickets = nn_layout.scratch(dev, stream, b, m)
    err = fn(q_pts.data_ptr(), q_mask_f.data_ptr(), int(q_mask_f.dim() == 3),
             layout.query_order.data_ptr(), int(layout.query_order.dim() == 2),
             t_pts.data_ptr(), t_boxes.data_ptr(), n_tiles,
             tn_t.data_ptr(), tc.data_ptr(), int(t_t.dim() == 3), r2.data_ptr(),
             keys.data_ptr(), block_part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
             b, m, n, splits, stream)
    cuda_build.check(err, "p2l_normal_eq")
    return out


def _check_layout(q_pts, q_mask_f, t_t, tn_t, tc, tv, r2):
    b, m, three = q_pts.shape
    n = t_t.shape[-1]
    batched = t_t.dim() == 3
    lead = (b,) if batched else ()
    want = {"t_t": lead + (3, n), "tn_t": lead + (3, n), "tc": lead + (1, n),
            "tv": lead + (1, n)}
    got = {"t_t": t_t, "tn_t": tn_t, "tc": tc, "tv": tv}
    bad = [k for k, s in want.items() if tuple(got[k].shape) != s]
    if (three != 3 or bad or tuple(q_mask_f.shape) not in ((m, 1), (b, m, 1))
            or r2.numel() != 1 or b > 65535):
        raise ValueError("p2l_normal_eq: expected q (B, M, 3), mask (M, 1) or "
                         "(B, M, 1), targets all 2-D (3|1, N) or all 3-D "
                         f"(B, 3|1, N), r2 (1, 1), B <= 65535; mismatch in {bad}")


def p2l_normal_eq(q_pts: torch.Tensor, q_mask_f: torch.Tensor,
                  t_t: torch.Tensor, tn_t: torch.Tensor, tc: torch.Tensor,
                  tv: torch.Tensor, r2: torch.Tensor,
                  layout: Optional[nn_layout.SweepLayout] = None) -> torch.Tensor:
    """Batched fused point-to-plane normal equations (the JAX kernel's
    signature, without its block-size constraints).

    q_pts (B, M, 3) transformed source points; q_mask_f (M, 1) or (B, M, 1)
    source validity; t_t, tn_t (3, N) or (B, 3, N) target points and unit
    normals, transposed; tc (1, N) or (B, 1, N) plane offsets n.t; tv (1, N)
    or (B, 1, N) target validity (2-D target arrays are shared across the
    batch); r2 (1, 1) squared max correspondence distance; ``layout`` the
    sweep's order of targets and queries (``nn_layout.SweepLayout``: the
    target layout that ``prepare_target`` returned with t_t and tv, and
    ``nn_layout.query_order``), made here from the inputs when not given.
    Returns (B, 8, 128); its inlier counts are NaN when the query order
    leaves out a valid query."""
    dev = q_pts.device
    _check_layout(q_pts, q_mask_f, t_t, tn_t, tc, tv, r2)
    if dev.type == "cpu":
        return p2l_normal_eq_plain(q_pts, q_mask_f, t_t, tn_t, tc, tv, r2)
    if dev.type != "cuda":
        raise RuntimeError(f"p2l_normal_eq: no kernel for device {dev}")
    for t in (q_pts, q_mask_f, t_t, tn_t, tc, tv, r2):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("p2l_normal_eq: every input must be a contiguous "
                             f"float32 tensor on {dev}")
    b, m, n = q_pts.shape[0], q_pts.shape[1], t_t.shape[-1]
    if layout is None:
        layout = nn_layout.layout_for(q_pts, q_mask_f, t_t, tv)
    nn_layout.check_layout(layout, b, m, n, dev, t_t, tv)
    cuda_build.count_launch("p2l_normal_eq", (b, m, n))
    return _launch_p2l(q_pts, q_mask_f, t_t, tn_t, tc, tv, r2, layout)


def prepare_target(points_sorted: torch.Tensor, normals_sorted: torch.Tensor,
                   valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, nn_layout.TargetLayout]:
    """The kernel's loop-invariant target arrays from points/normals
    (..., N, 3) and validity (..., N): t_t, tn_t (..., 3, N), tc, tv
    (..., 1, N), and the sweep's target layout, bound to t_t and tv.
    tc = n . t summed x, then y, then z, as ``jnp.sum(p * n, axis=-1)``
    sums three terms."""
    pn = points_sorted * normals_sorted
    tc = pn[..., 0] + pn[..., 1] + pn[..., 2]
    t_t = points_sorted.transpose(-1, -2).contiguous()
    tv = valid.to(torch.float32)[..., None, :].contiguous()
    return (t_t, normals_sorted.transpose(-1, -2).contiguous(),
            tc[..., None, :].contiguous(), tv,
            nn_layout.bind(nn_layout.target_layout(points_sorted, valid), t_t, tv))
