"""FPFH (Fast Point Feature Histograms) and feature matching.

Port of ``open3d_slam_tpu.ops.fpfh`` (replacing Open3D ``ComputeFPFHFeature``
as the reference's place recognition uses it, ``Submap.cpp:245``): pair
features (alpha, phi, theta) in the Darboux frame with Open3D's
source/target swap, 11 bins per feature, each neighbour adding 100/k to the
33-bin SPFH, then FPFH = SPFH + the distance-weighted neighbour SPFHs with
each 11-bin block renormalised to 100.  Neighbourhoods are exact hybrid
radius + k (``hashgrid.query_radius_bruteforce``); histograms are one-hot
sums, no scatter.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from open3d_slam_torch.ops import hashgrid
from open3d_slam_torch.utils.pointcloud import PointCloud

_EPS = 1e-12


def _clip_min(x: torch.Tensor, lo: float) -> torch.Tensor:
    return torch.clamp(x, min=lo)


def _pair_features(p1, n1, p2, n2):
    """Open3D ``ComputePairFeatures``: (alpha, phi, theta, dist, degenerate)."""
    dp = p2 - p1
    d = torch.linalg.norm(dp, dim=-1)
    dp_u = dp / _clip_min(d[..., None], _EPS)
    angle1 = (n1 * dp_u).sum(dim=-1)
    angle2 = (n2 * dp_u).sum(dim=-1)
    # Open3D swaps when acos|angle1| > acos|angle2|, i.e. |angle2| > |angle1|.
    swap = angle2.abs() > angle1.abs()
    u = torch.where(swap[..., None], n2, n1)
    nt = torch.where(swap[..., None], n1, n2)
    dp_s = torch.where(swap[..., None], -dp_u, dp_u)
    f2 = torch.where(swap, -angle2, angle1)
    v = torch.linalg.cross(dp_s, u, dim=-1)
    v_norm = torch.linalg.norm(v, dim=-1)
    v_u = v / _clip_min(v_norm[..., None], _EPS)
    w = torch.linalg.cross(u, v_u, dim=-1)
    f1 = (v_u * nt).sum(dim=-1)
    f3 = torch.atan2((w * nt).sum(dim=-1), (u * nt).sum(dim=-1))
    degenerate = (d < _EPS) | (v_norm < _EPS)
    zero = torch.zeros_like(f1)
    return (torch.where(degenerate, zero, f1), torch.where(degenerate, zero, f2),
            torch.where(degenerate, zero, f3), d, degenerate)


def _bin11(f1, f2, f3):
    """Open3D binning: 11 bins; f1, f2 in [-1, 1], f3 in [-pi, pi]."""
    b1 = torch.clamp(torch.floor(11.0 * (f1 + 1.0) * 0.5), 0, 10).to(torch.int32)
    b2 = torch.clamp(torch.floor(11.0 * (f2 + 1.0) * 0.5), 0, 10).to(torch.int32)
    b3 = torch.clamp(torch.floor(11.0 * (f3 + math.pi) / (2.0 * math.pi)),
                     0, 10).to(torch.int32)
    return b1, b2, b3


def _hist(bins: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(N, K) bins + (N, K) weights -> (N, 11) histogram, scatter-free."""
    arange = torch.arange(11, dtype=bins.dtype, device=bins.device)
    onehot = (bins[..., None] == arange).to(weights.dtype)
    return torch.einsum("nk,nkb->nb", weights, onehot)


def compute_fpfh(pc: PointCloud, radius: float, max_nn: int = 100) -> torch.Tensor:
    """FPFH features (N, 33) of the valid points (invalid rows zero); ``pc``
    must carry normals."""
    assert pc.normals is not None, "FPFH needs normals"
    n_pts = pc.capacity
    grid = hashgrid.build(pc, cell_size=radius)
    idx, _, valid = hashgrid.query_radius_bruteforce(grid, pc.points, radius,
                                                     max_neighbors=max_nn)
    idx = idx.long()
    q = grid.points_sorted[idx]
    nq = grid.normals_sorted[idx]
    f1, f2, f3, d, degenerate = _pair_features(pc.points[:, None, :],
                                               pc.normals[:, None, :], q, nq)
    is_self = d < 1e-9
    w_valid = valid & ~is_self & ~degenerate & pc.mask[:, None]
    counts = w_valid.to(torch.float32).sum(dim=1)
    hist_incr = torch.where(counts > 0, 100.0 / _clip_min(counts, 1.0),
                            torch.zeros_like(counts))
    wts = w_valid.to(torch.float32) * hist_incr[:, None]
    b1, b2, b3 = _bin11(f1, f2, f3)
    spfh = torch.cat([_hist(b1, wts), _hist(b2, wts), _hist(b3, wts)], dim=-1)
    # idx addresses grid slots: route the SPFHs through slot -> point index.
    neigh_spfh = spfh[grid.order.long()][idx]                      # (N, K, 33)
    inv_d = torch.where(w_valid, 1.0 / _clip_min(d, 1e-6), torch.zeros_like(d))
    agg = torch.einsum("nk,nkf->nf", inv_d, neigh_spfh)
    blocks = agg.reshape(n_pts, 3, 11)
    sums = blocks.sum(dim=-1, keepdim=True)
    blocks = torch.where(sums > 0, blocks * (100.0 / _clip_min(sums, _EPS)),
                         torch.zeros_like(blocks))
    fpfh = spfh + blocks.reshape(n_pts, 33)
    return torch.where(pc.mask[:, None], fpfh, torch.zeros_like(fpfh))


def match_features(feat_a: torch.Tensor, mask_a: torch.Tensor,
                   feat_b: torch.Tensor, mask_b: torch.Tensor,
                   mutual: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour in 33-D feature space for each row of ``feat_a``,
    from one (A, B) distance matrix (a plain float32 matrix product, outside
    any kernel).  Returns (index in b, valid)."""
    a2 = (feat_a * feat_a).sum(dim=-1, keepdim=True)
    b2 = (feat_b * feat_b).sum(dim=-1)
    d2 = a2 + b2[None, :] - 2.0 * (feat_a @ feat_b.t())
    inf = torch.full((), float("inf"), dtype=d2.dtype, device=d2.device)
    d2 = torch.where(mask_b[None, :], d2, inf)
    nn_ab = torch.argmin(d2, dim=1)
    valid = mask_a & torch.isfinite(d2.min(dim=1).values)
    if mutual:
        nn_ba = torch.argmin(torch.where(mask_a[:, None], d2, inf), dim=0)
        valid = valid & (nn_ba[nn_ab] == torch.arange(feat_a.shape[0],
                                                      device=feat_a.device))
    return nn_ab, valid
