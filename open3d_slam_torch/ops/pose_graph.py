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

One LM iteration is a step on a state, ``PGState(X, damping)``, as the
ICP loops are (``ops/gn_graph.py``): ``cuda_pose_graph.pg_linearize`` (the
residuals, line-process weights and per-edge blocks), ``pg_assemble`` (the
dense 6N x 6N normal equations with the prior and the damping), the dense
Cholesky factor and solve (``cholesky_ex`` + ``cholesky_solve``, the JAX
package's ``cho_factor``/``cho_solve``), and ``pg_step`` (the retraction, the
cost at it, the accept test and the damping update).  On CUDA tensors those
are hand-written kernels (``csrc/pose_graph.cu``) and the whole two-stage
solve, the prune between the stages and the final weights included, is one
CUDA graph per key, captured at its first call (``gn_graph.run_program``):
the JAX ``lax.scan``s have a fixed length and no convergence test, so the
graph reads nothing back; the caller's one pull is the only one.  On the CPU
the same program runs the kernels' plain versions, the port's earlier eager
code.  ``optimize_plain`` runs those on any device (the card's A/B).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from open3d_slam_torch.ops import cuda_pose_graph, gn_graph
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


class PGState(NamedTuple):
    X: torch.Tensor        # (N, 4, 4) node poses
    damping: torch.Tensor  # () LM damping


_PLAIN = (cuda_pose_graph.pg_linearize_plain, cuda_pose_graph.pg_assemble_plain,
          cuda_pose_graph.pg_step_plain)


def _routes(plain: bool):
    if plain:
        return _PLAIN
    # Looked up at each call, so that a stand-in for a wrapper sees it.
    return (cuda_pose_graph.pg_linearize, cuda_pose_graph.pg_assemble,
            cuda_pose_graph.pg_step)


def _program(g: Dict[str, torch.Tensor], preference_loop_closure: float,
             edge_prune_threshold: float, reference_node: int, max_iterations: int,
             damping_init: float, plain: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-stage solve on the graph's tensors ``g`` (``PoseGraphData``'s
    fields).  Issues no host read and no host-to-device copy, so that a
    CUDA graph can hold it."""
    linearize, assemble, step = _routes(plain)
    dtype = g["node_poses"].dtype        # float32; float64 for a plain reference
    like = dict(dtype=dtype, device=g["node_poses"].device)
    N = g["node_poses"].shape[0]
    # The JAX function's arithmetic with the ends swapped, so that the
    # residual is Open3D's log(T^-1 X_t^-1 X_s) (module docstring).
    e_a, e_b = g["edge_target"].long(), g["edge_source"].long()
    e_T, e_info, e_unc = g["edge_transform"], g["edge_information"], g["edge_uncertain"]
    edge_mask = g["edge_mask"]

    n_edges = torch.clamp(edge_mask.to(dtype).sum(), min=1.0)
    avg_corr = torch.where(edge_mask, e_info[:, 5, 5], torch.zeros((), **like)).sum() / n_edges
    mu = float(preference_loop_closure) * avg_corr
    # A comparison, not a one-hot of ``torch.tensor(reference_node)``: that
    # copies from the host, which a capture refuses.
    ref = (torch.arange(N, device=like["device"]) == int(reference_node)).to(dtype)
    prior = ref * 1e6 + (1.0 - g["node_mask"].to(dtype)) * 1e6 + 1e-8

    def lin(X, mask):
        return linearize(X, e_a, e_b, e_T, e_info, e_unc, mask, mu)

    def iteration(state: PGState, mask) -> PGState:
        blocks = lin(state.X, mask)
        Hd, b, cost = assemble(blocks, e_a, e_b, prior, state.damping)
        L, _ = torch.linalg.cholesky_ex(Hd)
        delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
        return PGState(*step(state.X, delta, e_a, e_b, e_T, e_info, blocks.w, cost,
                             state.damping))

    def run_lm(X, mask):
        state = PGState(X, torch.full((), float(damping_init), **like))
        for _ in range(max_iterations):
            state = iteration(state, mask)
        return state.X

    X1 = run_lm(g["node_poses"], edge_mask)
    w1 = lin(X1, edge_mask).w
    pruned = edge_mask & e_unc & (w1 < float(edge_prune_threshold))
    mask2 = edge_mask & ~pruned
    X2 = run_lm(X1, mask2)
    return X2, lin(X2, mask2).w, pruned


def _fields(graph: PoseGraphData) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(graph, f.name) for f in dataclasses.fields(graph)}


def optimize(graph: PoseGraphData, max_correspondence_distance: float,
             preference_loop_closure: float, edge_prune_threshold: float,
             reference_node: int, max_iterations: int = 25,
             damping_init: float = 1e-4
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimised node poses.  Returns (poses (N, 4, 4), edge weights (E,),
    pruned (E,) bool), as the JAX function.  ``max_correspondence_distance``
    is part of Open3D's option struct but does not enter the line process.
    On the card (``gn_graph.MODE == "graph"``) the solve replays one CUDA
    graph per key (``gn_graph.run_program``: the graph's arrays and the
    scalars, which the CUDA graph holds as constants)."""
    scalars = (float(preference_loop_closure), float(edge_prune_threshold),
               int(reference_node), int(max_iterations), float(damping_init))
    return gn_graph.run_program("pose_graph", scalars, _fields(graph),
                                lambda x: lambda: _program(x, *scalars))


def optimize_plain(graph: PoseGraphData, max_correspondence_distance: float,
                   preference_loop_closure: float, edge_prune_threshold: float,
                   reference_node: int, max_iterations: int = 25,
                   damping_init: float = 1e-4
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``optimize`` through the kernels' plain versions on any device, eager:
    the route the card ran before the kernels, kept for comparisons."""
    return _program(_fields(graph), float(preference_loop_closure),
                    float(edge_prune_threshold), int(reference_node), int(max_iterations),
                    float(damping_init), plain=True)


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
