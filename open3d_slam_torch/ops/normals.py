"""Normal and covariance estimation.

Port of ``open3d_slam_tpu.ops.normals``, flash semantics only: exact hybrid
radius + k neighbourhoods (Open3D ``KDTreeSearchParamHybrid``) from K2's two
kernels (``ops/cuda_normals.py``), the k-th-neighbour prepass and the
moments, both reading one layout of the centred support made per call, then
a closed-form symmetric 3x3 eigensolver.  The port takes this path on
every device.  (The JAX package's CPU path, a 27-cell hash-grid probe, is not
ported.)
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from open3d_slam_torch.ops import cuda_normals
from open3d_slam_torch.utils.pointcloud import PointCloud

_EPS = 1e-12


def _det3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def smallest_eigvec_sym3(C: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric 3x3 matrices:
    trigonometric eigenvalues + cross-product null space (Eigen's
    ``computeDirect``).  (..., 3, 3) -> (..., 3) unit vectors, (0, 0, 1) for
    degenerate input."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    tr = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    q = tr / 3.0
    A = C - q[..., None, None] * eye
    p2 = torch.sum(A * A, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    r = torch.clamp(_det3(A / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = C - eig3[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    best = torch.argmax(torch.sum(cands * cands, dim=-1), dim=-1)
    v = torch.take_along_dim(cands, best[..., None, None].expand(
        best.shape + (1, 3)), dim=-2)[..., 0, :]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    degenerate = (vn[..., 0] < 1e-10) | (p2 < _EPS)
    v = v / torch.clamp(vn, min=_EPS)
    ez = torch.zeros_like(v)
    ez[..., 2] = 1.0
    return torch.where(degenerate[..., None], ez, v)


def _finish_normals(points: torch.Tensor, cnt: torch.Tensor, cov: torch.Tensor,
                    orientation_reference: Optional[torch.Tensor]) -> torch.Tensor:
    normals = smallest_eigvec_sym3(cov)
    ez = torch.zeros_like(normals)
    ez[:, 2] = 1.0
    normals = torch.where((cnt < 3.0)[:, None], ez, normals)
    ref = (torch.zeros(3, dtype=points.dtype, device=points.device)
           if orientation_reference is None else orientation_reference)
    flip = torch.sum(normals * (ref[None, :] - points), dim=-1) < 0.0
    return torch.where(flip[:, None], -normals, normals)


def estimate_normals(pc: PointCloud, radius, max_nn: int = 20,
                     orientation_reference: Optional[torch.Tensor] = None) -> PointCloud:
    """Per-point PCA normals from hybrid radius+k neighbourhoods, normalised
    and oriented toward ``orientation_reference`` (default origin)."""
    pts, mask = pc.points, pc.mask
    layout = cuda_normals.normals_layout(pts, pts, mask)
    dk2 = cuda_normals.kth_neighbor_d2_within(pts, pts, mask, max_nn, radius, layout)
    r_pp = cuda_normals.hybrid_radius(radius, dk2)
    mom = cuda_normals.radius_moments_at(pts, pts, mask, r_pp, layout)
    cnt, cov = cuda_normals.moments_to_covariance(mom)
    return pc.with_(normals=_finish_normals(pc.points, cnt, cov,
                                            orientation_reference))


def estimate_normals_at(queries: PointCloud, support: PointCloud, radius,
                        max_nn: int = 20,
                        orientation_reference: Optional[torch.Tensor] = None) -> PointCloud:
    """Normals at ``queries`` from neighbourhoods of a SUPPORT cloud (equal to
    ``estimate_normals(support)`` at the query rows when the queries are a
    subset of the support)."""
    q, pts, mask = queries.points, support.points, support.mask
    layout = cuda_normals.normals_layout(q, pts, mask, queries.mask)
    dk2 = cuda_normals.kth_neighbor_d2_within(q, pts, mask, max_nn, radius, layout)
    r_pp = cuda_normals.hybrid_radius(radius, dk2)
    mom = cuda_normals.radius_moments_at(q, pts, mask, r_pp, layout)
    cnt, cov = cuda_normals.moments_to_covariance(mom)
    return queries.with_(normals=_finish_normals(queries.points, cnt, cov,
                                                 orientation_reference))


def covariances_from_normals(pc: PointCloud, epsilon: float = 1e-3) -> torch.Tensor:
    """Plane-regularised GICP covariances C = R diag(eps, 1, 1) R^T with R's
    first column the normal."""
    n = pc.normals
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    a = torch.where(torch.abs(n[:, :1]) < 0.9, eye[0], eye[1])
    u = torch.linalg.cross(n, a)
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=_EPS)
    v = torch.linalg.cross(n, u)
    R = torch.stack([n, u, v], dim=-1)
    D = eye.clone()
    D[0, 0] = epsilon
    return torch.einsum("nij,jk,nlk->nil", R, D, R)
