"""Fused Generalized-ICP normal equations: kernel K1 and what surrounds it.

Port of ``open3d_slam_tpu.ops.pallas_gicp`` (and ``pallas_icp.unpack``).
``gicp_normal_eq`` is the counterpart of the Pallas kernel of the same name:
on CUDA tensors it launches the hand-written kernel in ``csrc/gicp.cu``; on
CPU tensors it runs ``gicp_normal_eq_plain``, the same function in plain
PyTorch.  Output layout (B, 8, 128): [JtJ | Jtr; Jtr^T | rMr] in rows 0..6
and (inlier count, inlier d2 sum) in row 7.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from open3d_slam_torch.ops import cuda_build, nn_layout

_BIG = 3.0e38
_DIAG_EPS = 1e-6
_SQRT_TINY = 1e-12
_PLAIN_CHUNK = 1024


def _nn_plain(q: torch.Tensor, td: torch.Tensor, tv: torch.Tensor):
    """Exact difference-form nearest valid target, first index on ties."""
    best, arg = [], []
    valid = tv[0] > 0.0
    for s in range(0, q.shape[0], _PLAIN_CHUNK):
        qc = q[s:s + _PLAIN_CHUNK]
        d0 = qc[:, 0:1] - td[0:1, :]
        d1 = qc[:, 1:2] - td[1:2, :]
        d2_ = qc[:, 2:3] - td[2:3, :]
        d2 = d0 * d0 + d1 * d1 + d2_ * d2_
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, _BIG))
        a = torch.argmin(d2, dim=1)
        arg.append(a)
        best.append(torch.gather(d2, 1, a[:, None])[:, 0])
    return torch.cat(best), torch.cat(arg)


def _gicp_rows(q: torch.Tensor, qc: torch.Tensor, S: torch.Tensor,
               wf: torch.Tensor) -> torch.Tensor:
    """Whitened rows B = L^-1 [J | r] per source point, as (3M, 7) * wf."""
    p0, p1, p2 = q[:, 0:1], q[:, 1:2], q[:, 2:3]
    a00 = S[:, 3:4] + qc[:, 0:1] + _DIAG_EPS
    a01 = S[:, 4:5] + qc[:, 1:2]
    a02 = S[:, 5:6] + qc[:, 2:3]
    a11 = S[:, 6:7] + qc[:, 3:4] + _DIAG_EPS
    a12 = S[:, 7:8] + qc[:, 4:5]
    a22 = S[:, 8:9] + qc[:, 5:6] + _DIAG_EPS
    l00 = torch.sqrt(torch.clamp(a00, min=_SQRT_TINY))
    inv_l00 = 1.0 / l00
    l10 = a01 * inv_l00
    l20 = a02 * inv_l00
    l11 = torch.sqrt(torch.clamp(a11 - l10 * l10, min=_SQRT_TINY))
    inv_l11 = 1.0 / l11
    l21 = (a12 - l20 * l10) * inv_l11
    l22 = torch.sqrt(torch.clamp(a22 - l20 * l20 - l21 * l21, min=_SQRT_TINY))
    inv_l22 = 1.0 / l22
    zero, one = torch.zeros_like(p0), torch.ones_like(p0)
    r0, r1, r2_ = p0 - S[:, 0:1], p1 - S[:, 1:2], p2 - S[:, 2:3]
    x0 = torch.cat([zero, p2, -p1, one, zero, zero, r0], dim=1)
    x1 = torch.cat([-p2, zero, p0, zero, one, zero, r1], dim=1)
    x2 = torch.cat([p1, -p0, zero, zero, zero, one, r2_], dim=1)
    y0 = x0 * inv_l00
    y1 = (x1 - l10 * y0) * inv_l11
    y2 = (x2 - l20 * y0 - l21 * y1) * inv_l22
    return torch.cat([y0 * wf, y1 * wf, y2 * wf], dim=0)


def gicp_normal_eq_plain(q_pts, q_mask_f, q_cov6, td, tv, r2,
                         t_aabb=None, layout=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  ``t_aabb`` and ``layout`` are
    accepted and ignored: the tile skip is exact, so the result does not
    depend on them."""
    b, m, _ = q_pts.shape
    out = torch.zeros((b, 8, 128), dtype=torch.float32, device=q_pts.device)
    for i in range(b):
        tdb = td[i] if td.dim() == 3 else td
        tvb = tv[i] if tv.dim() == 3 else tv
        qm = q_mask_f[i] if q_mask_f.dim() == 3 else q_mask_f
        best, arg = _nn_plain(q_pts[i], tdb, tvb)
        wf = ((best[:, None] <= r2.reshape(1, 1)) & (qm > 0.0)).to(torch.float32)
        G = _gicp_rows(q_pts[i], q_cov6[i], tdb[:, arg].t(), wf)
        out[i, 0:7, 0:7] = G.t() @ G
        out[i, 7, 0] = wf.sum()
        out[i, 7, 1] = (wf * best[:, None]).sum()
    return out


def _launch_gicp(q_pts, q_mask_f, q_cov6, td, tv, r2,
                 layout: nn_layout.SweepLayout) -> torch.Tensor:
    lib = cuda_build.load("gicp")
    fn = lib.gicp_normal_eq_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] +
                   [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] +
                   [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5 +
                   [ctypes.c_int] * 4 + [ctypes.c_void_p])
    b, m, _ = q_pts.shape
    n = td.shape[-1]
    dev = q_pts.device
    t_pts, t_boxes = layout.target.pts, layout.target.boxes
    n_tiles = t_boxes.shape[-2]
    q_blocks = -(-m // lib.gicp_block_size())
    if (lib.gicp_tile_size(), lib.gicp_group_size()) != (nn_layout.TILE, nn_layout.GROUP):
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
             q_cov6.data_ptr(), td.data_ptr(), int(td.dim() == 3), r2.data_ptr(),
             keys.data_ptr(), block_part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
             b, m, n, splits, stream)
    cuda_build.check(err, "gicp_normal_eq")
    return out


def gicp_normal_eq(q_pts: torch.Tensor, q_mask_f: torch.Tensor,
                   q_cov6: torch.Tensor, td: torch.Tensor, tv: torch.Tensor,
                   r2: torch.Tensor, t_aabb: Optional[torch.Tensor] = None,
                   layout: Optional[nn_layout.SweepLayout] = None
                   ) -> torch.Tensor:
    """Batched fused GICP normal equations (the JAX kernel's signature).

    q_pts (B, M, 3) transformed source points; q_mask_f (M, 1) or (B, M, 1);
    q_cov6 (B, M, 6) source covariance entries already rotated (R C R^T);
    td (9, N) or (B, 9, N) target rows [x, y, z, c00, c01, c02, c11, c12,
    c22] (2-D is shared across the batch); tv (1, N) or (B, 1, N) target
    validity; r2 (1, 1) squared max correspondence distance; t_aabb, the
    JAX signature's per-tile boxes, is accepted and not used: the kernel
    skips by the boxes of ``layout``, the sweep's order of targets and
    queries (``nn_layout.SweepLayout``: the target layout that
    ``prepare_target`` returned with td and tv, and
    ``nn_layout.query_order``), made here from the inputs when not given.
    Returns (B, 8, 128); its inlier counts are NaN when the query order
    leaves out a valid query."""
    dev = q_pts.device
    if dev.type == "cpu":
        return gicp_normal_eq_plain(q_pts, q_mask_f, q_cov6, td, tv, r2, t_aabb)
    if dev.type != "cuda":
        raise RuntimeError(f"gicp_normal_eq: no kernel for device {dev}")
    for t in (q_pts, q_mask_f, q_cov6, td, tv, r2):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("gicp_normal_eq: every input must be a contiguous "
                             f"float32 tensor on {dev}")
    b, m, n = q_pts.shape[0], q_pts.shape[1], td.shape[-1]
    if layout is None:
        layout = nn_layout.layout_for(q_pts, q_mask_f, td, tv)
    nn_layout.check_layout(layout, b, m, n, dev, td, tv)
    cuda_build.count_launch("gicp_normal_eq", (b, m, n))
    return _launch_gicp(q_pts, q_mask_f, q_cov6, td, tv, r2, layout)


def plain_disagreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a kernel output (B, 8, 128) lies from the plain version's on
    the same inputs, entry by entry, each entry on its own scale:

    - ``n_in_equal``: the inlier counts are equal (both sides test the same
      term-by-term rounded distances, so they must be);
    - ``rest_equal``: every entry outside the Gram block and the two stats
      is equal (zero on both sides);
    - ``gram``: the largest |dG_ij| / sqrt(|G_ii| |G_jj|) over the 7x7
      [JtJ | Jtr; Jtr^T | rMr] block.  sqrt(G_ii G_jj) bounds sum_k |B_ki
      B_kj| (Cauchy-Schwarz), and so the rounding of a sum taken in another
      order: Jtr and rMr are held at their own size, not at JtJ's;
    - ``d2s``: the largest |d d2_sum| / d2_sum;
    - ``max_abs_err``: the largest |got - want| of all."""
    got, want = got.double(), want.double()
    tiny = torch.finfo(torch.float32).tiny
    diag = torch.diagonal(want[:, :7, :7], dim1=-2, dim2=-1).abs()
    scale = torch.sqrt(diag[:, :, None] * diag[:, None, :]).clamp(min=tiny)
    rest = torch.ones(want.shape[1:], dtype=torch.bool, device=want.device)
    rest[:7, :7] = False
    rest[7, :2] = False
    return {
        "n_in_equal": bool(torch.equal(got[:, 7, 0], want[:, 7, 0])),
        "rest_equal": bool(torch.equal(got[:, rest], want[:, rest])),
        "gram": float(((got[:, :7, :7] - want[:, :7, :7]).abs() / scale).max()),
        "d2s": float(((got[:, 7, 1] - want[:, 7, 1]).abs()
                      / want[:, 7, 1].abs().clamp(min=tiny)).max()),
        "max_abs_err": float((got - want).abs().max()),
    }


def unpack(out: torch.Tensor):
    """Split kernel output (..., 8, 128) -> (JtJ, Jtr, n_inlier, d2_sum)."""
    return out[..., 0:6, 0:6], out[..., 0:6, 6], out[..., 7, 0], out[..., 7, 1]


def tile_aabbs(points_sorted: torch.Tensor, valid: torch.Tensor,
               block_n: int) -> torch.Tensor:
    """Per-target-tile boxes (N / block_n, 8): [min xyz, max xyz, 0, 0];
    invalid points contribute +/-BIG so an all-invalid tile overlaps nothing."""
    n = points_sorted.shape[0]
    tiles = points_sorted.reshape(n // block_n, block_n, 3)
    v = valid.reshape(n // block_n, block_n, 1)
    mins = torch.where(v, tiles, torch.full_like(tiles, _BIG)).min(dim=1).values
    maxs = torch.where(v, tiles, torch.full_like(tiles, -_BIG)).max(dim=1).values
    pad = torch.zeros((n // block_n, 2), dtype=torch.float32, device=points_sorted.device)
    return torch.cat([mins, maxs, pad], dim=1)


def cov6_from_full(C: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) entries [c00, c01, c02, c11, c12, c22]."""
    return torch.stack([C[..., 0, 0], C[..., 0, 1], C[..., 0, 2],
                        C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]], dim=-1)


def rotate_cov6(R: torch.Tensor, cov6: torch.Tensor) -> torch.Tensor:
    """Entries of R C R^T from entries of C.  R (..., 3, 3), cov6 (..., N, 6)."""
    c00, c01, c02, c11, c12, c22 = cov6.unbind(-1)
    C = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                     torch.stack([c01, c11, c12], dim=-1),
                     torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    RC = torch.einsum("...ij,...njk->...nik", R, C)
    return cov6_from_full(torch.einsum("...nik,...jk->...nij", RC, R))


def prepare_target(points_sorted: torch.Tensor, covs_sorted: torch.Tensor,
                   valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, nn_layout.TargetLayout]:
    """Loop-invariant target arrays: td (..., 9, N), tv (..., 1, N), and
    the sweep's target layout, bound to td and tv."""
    td = torch.cat([points_sorted.transpose(-1, -2),
                    cov6_from_full(covs_sorted).transpose(-1, -2)], dim=-2).contiguous()
    tv = valid.to(torch.float32)[..., None, :].contiguous()
    return td, tv, nn_layout.bind(nn_layout.target_layout(points_sorted, valid), td, tv)
