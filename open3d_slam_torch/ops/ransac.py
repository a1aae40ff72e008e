"""Batched RANSAC global registration on feature correspondences.

Port of ``open3d_slam_tpu.ops.ransac`` (replacing Open3D
``RegistrationRANSACBasedOnFeatureMatching`` as the reference's loop-closure
detection uses it, ``PlaceRecognition.cpp:81-85``): FPFH correspondences,
a fixed batch of 3-point hypotheses fitted with Umeyama and checked by edge
length and distance, all scored on the full correspondence set, then the
best one refitted on all of its inliers.

torch cannot reproduce ``jax.random.randint``, so the (H, 3) integer draws
are an input: the caller draws them from its own seeded generator, and the
parity tests pass in the JAX package's draws.
"""
from __future__ import annotations

import dataclasses

import torch

from open3d_slam_torch.ops.fpfh import match_features
from open3d_slam_torch.utils.pointcloud import PointCloud

_SCORE_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class RansacResult:
    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor         # inlier fraction of the correspondence set
    inlier_rmse: torch.Tensor
    num_inliers: torch.Tensor     # int32


def _det3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _rotation_from_cross_covariance(Hm: torch.Tensor) -> torch.Tensor:
    """Umeyama rotation R = V D U^T from H = U S V^T (batched (..., 3, 3)),
    with D = diag(1, 1, sign det(V U^T))."""
    U, _, Vt = torch.linalg.svd(Hm)
    V = Vt.transpose(-1, -2)
    d = torch.sign(_det3(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return V @ D @ U.transpose(-1, -2)


def _transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _umeyama_triplets(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rigid transforms from point triplets (no scaling): p, q (H, 3, 3)."""
    p_bar = p.mean(dim=1)
    q_bar = q.mean(dim=1)
    Hm = (p - p_bar[:, None]).transpose(-1, -2) @ (q - q_bar[:, None])
    R = _rotation_from_cross_covariance(Hm)
    return _transform(R, q_bar - (R @ p_bar[..., None])[..., 0])


def _edge_lengths(x: torch.Tensor) -> torch.Tensor:
    e01 = torch.linalg.norm(x[:, 0] - x[:, 1], dim=-1)
    e12 = torch.linalg.norm(x[:, 1] - x[:, 2], dim=-1)
    e02 = torch.linalg.norm(x[:, 0] - x[:, 2], dim=-1)
    return torch.stack([e01, e12, e02], dim=-1)


def ransac_feature_registration(source: PointCloud, source_features: torch.Tensor,
                                target: PointCloud, target_features: torch.Tensor,
                                draws: torch.Tensor, max_correspondence_distance: float,
                                edge_length_similarity: float = 0.9,
                                distance_threshold=None,
                                mutual_filter: bool = False) -> RansacResult:
    """Best rigid transform aligning ``source`` onto ``target``.  ``draws``
    (H, 3) are non-negative integers, reduced modulo the number of valid
    correspondences to pick each hypothesis's triplet."""
    if distance_threshold is None:
        distance_threshold = max_correspondence_distance
    dev = source.device
    f32 = dict(dtype=torch.float32, device=dev)
    max_dist = torch.tensor(float(max_correspondence_distance), **f32)
    max_d2 = max_dist * max_dist
    dist_thr = torch.tensor(float(distance_threshold), **f32)

    nn_idx, corr_valid = match_features(source_features, source.mask,
                                        target_features, target.mask,
                                        mutual=mutual_filter)
    src_pts = source.points
    tgt_pts = target.points[nn_idx]
    n_corr = corr_valid.to(torch.float32).sum()

    order = torch.argsort((~corr_valid).to(torch.int32), stable=True)   # valid first
    n_valid = torch.clamp(corr_valid.to(torch.int64).sum(), min=1)
    samp = order[draws.to(dev).long() % n_valid]                        # (H, 3)
    p3, q3 = src_pts[samp], tgt_pts[samp]
    T_h = _umeyama_triplets(p3, q3)

    es, et = _edge_lengths(p3), _edge_lengths(q3)
    sim = float(edge_length_similarity)
    ok_edge = ((es > sim * et) & (et > sim * es)).all(dim=-1)
    p3_t = torch.einsum("hij,hkj->hki", T_h[:, :3, :3], p3) + T_h[:, None, :3, 3]
    ok_dist = (torch.linalg.norm(p3_t - q3, dim=-1) < dist_thr).all(dim=-1)
    distinct = ((samp[:, 0] != samp[:, 1]) & (samp[:, 1] != samp[:, 2]) &
                (samp[:, 0] != samp[:, 2]))
    ok = ok_edge & ok_dist & distinct

    cnts, rmses = [], []
    for s in range(0, T_h.shape[0], _SCORE_CHUNK):
        Tc = T_h[s:s + _SCORE_CHUNK]
        p_t = torch.einsum("hij,sj->hsi", Tc[:, :3, :3], src_pts) + Tc[:, None, :3, 3]
        d2 = ((p_t - tgt_pts[None]) ** 2).sum(dim=-1)
        inl = (d2 < max_d2) & corr_valid[None, :]
        cnt = inl.to(torch.float32).sum(dim=-1)
        cnts.append(cnt)
        rmses.append(torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum(dim=-1) /
                                torch.clamp(cnt, min=1.0)))
    cnts = torch.where(ok, torch.cat(cnts), torch.full((), -1.0, **f32))
    rmses = torch.cat(rmses)
    # Best by inlier count, ties by lower rmse; argmax takes the first max.
    score = cnts - rmses / torch.clamp(rmses.max(), min=1e-6) * 0.5
    best = torch.argmax(score)
    T_best = T_h[best]

    # Refit on all inliers of the winner (weighted Umeyama); kept only if it
    # does not lose inliers.
    def inliers_of(T):
        d2 = ((src_pts @ T[:3, :3].t() + T[:3, 3] - tgt_pts) ** 2).sum(dim=-1)
        return d2, (d2 < max_d2) & corr_valid

    d2, inl = inliers_of(T_best)
    wf = inl.to(torch.float32)[:, None]
    n_in = torch.clamp(wf.sum(), min=3.0)
    p_bar = (src_pts * wf).sum(dim=0) / n_in
    q_bar = (tgt_pts * wf).sum(dim=0) / n_in
    Hm = ((src_pts - p_bar) * wf).t() @ (tgt_pts - q_bar)
    R_ref = _rotation_from_cross_covariance(Hm)
    T_refit = _transform(R_ref, q_bar - R_ref @ p_bar)
    d2_2, inl2 = inliers_of(T_refit)
    cnt2 = inl2.to(torch.float32).sum()
    use_refit = cnt2 >= cnts[best]
    T_final = torch.where(use_refit, T_refit, T_best)
    cnt_f = torch.where(use_refit, cnt2, cnts[best])
    d2_f = torch.where(use_refit, d2_2, d2)
    inl_f = torch.where(use_refit, inl2, inl)
    rmse_f = torch.sqrt(torch.where(inl_f, d2_f, torch.zeros_like(d2_f)).sum() /
                        torch.clamp(inl_f.to(torch.float32).sum(), min=1.0))
    return RansacResult(transformation=T_final,
                        fitness=cnt_f / torch.clamp(n_corr, min=1.0),
                        inlier_rmse=rmse_f,
                        num_inliers=torch.clamp(cnt_f, min=0.0).to(torch.int32))
