"""Pose-graph optimisation: batched robust Levenberg-Marquardt.

Port of ``open3d_slam_tpu.ops.pose_graph`` (replacing Open3D's
``GlobalOptimization`` as the reference's ``OptimizationProblem::solve`` uses
it, ``OptimizationProblem.cpp:25-44``): odometry edges at weight 1,
loop-closure edges with Geman-McClure line-process weights, a two-stage
prune-and-reoptimise, the reference node pinned by a strong prior.

An edge (s, t, T) holds when X_t^-1 X_s = T, Open3D's convention
(``GlobalOptimization.cpp``, ``GetDiffVec``: residual log(T^-1 X_t^-1 X_s)),
with node poses X the per-submap corrections and T the ICP transform that
moves the source submap onto the target.  ``OptimizationProblem`` chains its
nodes by the same rule.  The JAX package's ``optimize`` takes the residual
log(T^-1 X_s^-1 X_t) instead, which reverses every edge: a loop closure then
moves the drifted submap by its drift once more instead of taking it back
(``tests/test_torch_loop_closure.py``).  The port keeps Open3D's convention;
it equals the JAX function on the same graph with each edge's ends swapped.

The 6N x 6N normal matrix is assembled with one-hot einsums, as in the JAX
package: a fixed-order reduction with no scatter, so no float atomics and
bit-reproducible solves on the card.  Each stage runs its LM steps as a
Python loop with the accept test on the device (``torch.where``) and no host
read; ``cholesky_ex`` skips the host-side error check of
``torch.linalg.cholesky``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from open3d_slam_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class PoseGraphData:
    """Padded pose graph (fixed capacity)."""

    node_poses: torch.Tensor        # (N, 4, 4)
    node_mask: torch.Tensor         # (N,) bool
    edge_source: torch.Tensor       # (E,) int64
    edge_target: torch.Tensor       # (E,) int64
    edge_transform: torch.Tensor    # (E, 4, 4) source->target: X_t^-1 X_s
    edge_information: torch.Tensor  # (E, 6, 6)
    edge_uncertain: torch.Tensor    # (E,) bool
    edge_mask: torch.Tensor         # (E,) bool


def _edge_residual(X, e_a, e_b, e_T):
    """r = log(T^-1 X_a^-1 X_b) per edge, (E, 6); ``optimize`` passes
    a = target, b = source."""
    rel = se3.inverse(X[e_a]) @ X[e_b]
    return se3.se3_log(se3.inverse(e_T) @ rel)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint (..., 6, 6) for xi = (omega, v) ordering."""
    R = T[..., :3, :3]
    tx = se3.hat(T[..., :3, 3])
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([tx @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _quad(r, info):
    return torch.einsum("ei,eij,ej->e", r, info, r)


def optimize(graph: PoseGraphData, max_correspondence_distance: float,
             preference_loop_closure: float, edge_prune_threshold: float,
             reference_node: int, max_iterations: int = 25,
             damping_init: float = 1e-4
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimised node poses.  Returns (poses (N, 4, 4), edge weights (E,),
    pruned (E,) bool), as the JAX function.  ``max_correspondence_distance``
    is part of Open3D's option struct but does not enter the line process."""
    dev = graph.node_poses.device
    f32 = dict(dtype=torch.float32, device=dev)
    N = graph.node_poses.shape[0]
    # The JAX function's arithmetic with the ends swapped, so that the
    # residual is Open3D's log(T^-1 X_t^-1 X_s) (module docstring).
    e_src, e_tgt = graph.edge_target.long(), graph.edge_source.long()
    e_T, e_info, e_unc = graph.edge_transform, graph.edge_information, graph.edge_uncertain
    zero = torch.zeros((), **f32)

    n_edges = torch.clamp(graph.edge_mask.to(torch.float32).sum(), min=1.0)
    avg_corr = torch.where(graph.edge_mask, e_info[:, 5, 5], zero).sum() / n_edges
    mu = float(preference_loop_closure) * avg_corr

    S = torch.nn.functional.one_hot(e_src, N).to(torch.float32)     # (E, N)
    Tm = torch.nn.functional.one_hot(e_tgt, N).to(torch.float32)
    ref = torch.nn.functional.one_hot(torch.tensor(int(reference_node), device=dev),
                                      N).to(torch.float32)
    prior = ref * 1e6 + (1.0 - graph.node_mask.to(torch.float32)) * 1e6 + 1e-8
    prior_diag = torch.diag(torch.repeat_interleave(prior, 6))

    def weights(r, e_mask):
        w_lc = (mu / (mu + _quad(r, e_info))) ** 2
        w = torch.where(e_unc, w_lc, torch.ones((), **f32))
        return torch.where(e_mask, w, zero)

    def build_normal_eqs(X, w):
        r = _edge_residual(X, e_src, e_tgt, e_T)                       # (E, 6)
        rel = se3.inverse(X[e_src]) @ X[e_tgt]
        J_s = -_adjoint(se3.inverse(rel))                               # (E, 6, 6)
        lam = e_info * w[:, None, None]
        H_ss = torch.einsum("eki,ekl,elj->eij", J_s, lam, J_s)
        H_st = torch.einsum("eki,ekj->eij", J_s, lam)
        b_s = torch.einsum("eki,ekl,el->ei", J_s, lam, r)
        b_t = torch.einsum("eij,ej->ei", lam, r)
        H = (torch.einsum("ea,eb,eij->aibj", S, S, H_ss) +
             torch.einsum("ea,eb,eij->aibj", S, Tm, H_st) +
             torch.einsum("ea,eb,eij->aibj", Tm, S, H_st.transpose(-1, -2)) +
             torch.einsum("ea,eb,eij->aibj", Tm, Tm, lam))
        b = torch.einsum("ea,ei->ai", S, b_s) + torch.einsum("ea,ei->ai", Tm, b_t)
        H = H.reshape(N * 6, N * 6) + prior_diag
        cost = (w * _quad(r, e_info)).sum()
        return H, b.reshape(N * 6), cost

    def run_lm(X, e_mask):
        damping = torch.full((), float(damping_init), **f32)
        for _ in range(max_iterations):
            w = weights(_edge_residual(X, e_src, e_tgt, e_T), e_mask)
            H, b, cost = build_normal_eqs(X, w)
            Hd = H + damping * torch.diag(torch.diagonal(H))
            L, _ = torch.linalg.cholesky_ex(Hd)
            delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
            X_new = X @ se3.se3_exp(delta.reshape(N, 6))
            r_new = _edge_residual(X_new, e_src, e_tgt, e_T)
            accept = (w * _quad(r_new, e_info)).sum() < cost
            X = torch.where(accept, X_new, X)
            damping = torch.clamp(torch.where(accept, damping * 0.5, damping * 4.0),
                                  1e-9, 1e6)
        return X

    X1 = run_lm(graph.node_poses, graph.edge_mask)
    w1 = weights(_edge_residual(X1, e_src, e_tgt, e_T), graph.edge_mask)
    pruned = graph.edge_mask & e_unc & (w1 < float(edge_prune_threshold))
    mask2 = graph.edge_mask & ~pruned
    X2 = run_lm(X1, mask2)
    return X2, weights(_edge_residual(X2, e_src, e_tgt, e_T), mask2), pruned


def information_matrix_from_correspondences(target_points: torch.Tensor,
                                            corr_mask: torch.Tensor) -> torch.Tensor:
    """Open3D ``GetInformationMatrixFromPointClouds`` core: the sum over
    correspondences of G^T G with G = [-[q]_x | I] (q the target point).
    Returns (6, 6)."""
    q = target_points
    rot = -se3.hat(q)                                               # (N, 3, 3)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(rot.shape)
    G = torch.cat([rot, eye], dim=-1)                               # (N, 3, 6)
    w = corr_mask.to(q.dtype)[:, None, None]
    return torch.einsum("nki,nkj->ij", G * w, G)
