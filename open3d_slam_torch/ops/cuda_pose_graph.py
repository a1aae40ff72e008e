"""The pose-graph LM step: edge linearization, normal-equation assembly,
retraction and accept.

One Levenberg-Marquardt iteration of ``ops/pose_graph.optimize`` (the JAX
package's ``lm_step`` in ``open3d_slam_tpu/ops/pose_graph.py:110-162``, an
XLA program) is three kernels around a dense Cholesky solve:

- ``pg_linearize``: per edge, the residual r = log(T^-1 X_a^-1 X_b), the
  line-process weight w, the blocks H_ss = J_s^T lam J_s, H_st = J_s^T lam,
  H_tt = lam (lam = w info), b_s = J_s^T lam r, b_t = lam r, and the cost
  term w r^T info r;
- ``pg_assemble``: the dense (6N, 6N) matrix from those blocks, plus the
  prior diagonal and the LM damping (H + damping diag(H)), b, and the cost;
- ``pg_step``: X_new = X exp(delta) per node, the cost at X_new with the
  same weights, the accept test and the damping update.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/pose_graph.cu``) or raises; on CPU tensors it runs the ``*_plain``
version, the port's earlier eager code for the same step.  The kernels sum
in a fixed order with no float atomics, so a solve repeats bit for bit; the
plain versions round elsewhere (the one-hot einsums, batched 4x4 products),
so the two agree within float32 rounding, not bit for bit.  Indices are the
edge ends as ``optimize`` hands them: a = ``edge_target``, b =
``edge_source`` (Open3D's convention, ``ops/pose_graph.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from open3d_slam_torch.ops import cuda_build
from open3d_slam_torch.utils import se3


class EdgeBlocks(NamedTuple):
    """One linearization of the edges at the poses X."""

    r: torch.Tensor       # (E, 6) residual
    w: torch.Tensor       # (E,) line-process weight (0 off the stage's mask)
    H_ss: torch.Tensor    # (E, 6, 6) J_s^T lam J_s
    H_st: torch.Tensor    # (E, 6, 6) J_s^T lam
    H_tt: torch.Tensor    # (E, 6, 6) lam = w info
    b_s: torch.Tensor     # (E, 6) J_s^T lam r
    b_t: torch.Tensor     # (E, 6) lam r
    cost: torch.Tensor    # (E,) w r^T info r


def edge_residual(X, e_a, e_b, e_T):
    """r = log(T^-1 X_a^-1 X_b) per edge, (E, 6)."""
    rel = se3.inverse(X[e_a]) @ X[e_b]
    return se3.se3_log(se3.inverse(e_T) @ rel)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint (..., 6, 6) for xi = (omega, v) ordering."""
    R = T[..., :3, :3]
    tx = se3.hat(T[..., :3, 3])
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([tx @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def quad(r, info):
    return torch.einsum("ei,eij,ej->e", r, info, r)


def residual_tolerance(X, e_a, e_b, e_T, rtol: float = 1e-5, draws: int = 16) -> torch.Tensor:
    """Per edge (E, 1), how far two float32 evaluations of ``edge_residual``
    that round differently may lie apart: ``rtol`` of (1 + the largest
    component), plus twice the largest gap to the float64 residual of
    ``draws`` float32 residuals with every entry of X and T moved by up to
    one float32 ulp.  The SE(3) log is ill-conditioned in float32 in places
    (the JAX package's formula, shared): its V^-1 term cancels for 1e-4 <
    theta < ~0.05 (one rounding of cos(theta) moves v by ~2 eps |v| /
    theta^2: 0.6 m at theta = 1e-3 and |v| = 11 m), and near pi it divides
    by sin(theta); the draws measure that at each edge's input."""
    f64 = dict(dtype=torch.float64, device=X.device)
    X64, T64 = X.to(torch.float64), e_T.to(torch.float64)
    r64 = edge_residual(X64, e_a, e_b, T64)
    gen = torch.Generator(device=X.device).manual_seed(0)
    spread = torch.zeros((r64.shape[0], 1), **f64)

    def moved(t):
        return (t * (1.0 + 2.0 ** -23 * (2.0 * torch.rand(t.shape, generator=gen, **f64) - 1.0))
                ).to(torch.float32)

    for _ in range(draws):
        r32 = edge_residual(moved(X64), e_a, e_b, moved(T64)).to(torch.float64)
        spread = torch.maximum(spread, (r32 - r64).abs().amax(-1, keepdim=True))
    return rtol * (1.0 + r64.abs().amax(-1, keepdim=True)) + 2.0 * spread


def pg_linearize_plain(X, e_a, e_b, e_T, e_info, e_unc, e_mask, mu) -> EdgeBlocks:
    """The kernel's function in plain PyTorch (the JAX package's ``weights``
    and the per-edge half of ``build_normal_eqs``)."""
    return linearize_at(X, e_a, e_b, e_info, e_unc, e_mask, mu,
                        edge_residual(X, e_a, e_b, e_T))


def linearize_at(X, e_a, e_b, e_info, e_unc, e_mask, mu, r) -> EdgeBlocks:
    """``pg_linearize_plain`` given the residuals r (E, 6): the weights and
    blocks that follow from them (a card check recomputes these in float64
    from the kernel's own r)."""
    w_lc = (mu / (mu + quad(r, e_info))) ** 2
    w = torch.where(e_unc, w_lc, torch.ones((), dtype=X.dtype, device=X.device))
    w = torch.where(e_mask, w, torch.zeros((), dtype=X.dtype, device=X.device))
    # Right-perturbation Jacobians: J_b = I, J_a = -Ad((X_a^-1 X_b)^-1).
    rel = se3.inverse(X[e_a]) @ X[e_b]
    J_s = -adjoint(se3.inverse(rel))
    lam = e_info * w[:, None, None]
    H_ss = torch.einsum("eki,ekl,elj->eij", J_s, lam, J_s)
    H_st = torch.einsum("eki,ekj->eij", J_s, lam)
    b_s = torch.einsum("eki,ekl,el->ei", J_s, lam, r)
    b_t = torch.einsum("eij,ej->ei", lam, r)
    return EdgeBlocks(r, w, H_ss, H_st, lam, b_s, b_t, w * quad(r, e_info))


def pg_assemble_plain(blocks: EdgeBlocks, e_a, e_b, prior, damping
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the one-hot einsum assembly
    of the JAX package's ``build_normal_eqs``, its prior, and the LM
    damping.  Returns (H + damping diag(H) (6N, 6N), b (6N,), cost ())."""
    N = prior.shape[0]
    S = torch.nn.functional.one_hot(e_a, N).to(prior.dtype)        # (E, N)
    Tm = torch.nn.functional.one_hot(e_b, N).to(prior.dtype)
    H = (torch.einsum("ea,eb,eij->aibj", S, S, blocks.H_ss) +
         torch.einsum("ea,eb,eij->aibj", S, Tm, blocks.H_st) +
         torch.einsum("ea,eb,eij->aibj", Tm, S, blocks.H_st.transpose(-1, -2)) +
         torch.einsum("ea,eb,eij->aibj", Tm, Tm, blocks.H_tt))
    b = torch.einsum("ea,ei->ai", S, blocks.b_s) + torch.einsum("ea,ei->ai", Tm, blocks.b_t)
    H = H.reshape(N * 6, N * 6) + torch.diag(torch.repeat_interleave(prior, 6))
    Hd = H + damping * torch.diag(torch.diagonal(H))
    return Hd, b.reshape(N * 6), blocks.cost.sum()


def pg_step_plain(X, delta, e_a, e_b, e_T, e_info, w, cost, damping
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the retraction X exp(delta),
    the cost at it with the weights ``w``, accept if lower than ``cost``,
    and the damping halved on accept, else quadrupled, within [1e-9, 1e6].
    Returns (X (N, 4, 4), damping ())."""
    X_new = X @ se3.se3_exp(delta.reshape(X.shape[0], 6))
    accept = (w * quad(edge_residual(X_new, e_a, e_b, e_T), e_info)).sum() < cost
    damping = torch.clamp(torch.where(accept, damping * 0.5, damping * 4.0), 1e-9, 1e6)
    return torch.where(accept, X_new, X), damping


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(cuda_build.load("pose_graph"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    return fn


def _check(what: str, dev: torch.device, floats=(), indices=(), flags=()):
    if dev.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {dev}")
    for t in (*floats, *indices, *flags):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: every input must be a contiguous tensor on {dev}")
    if (any(t.dtype != torch.float32 for t in floats)
            or any(t.dtype != torch.int64 for t in indices)
            or any(t.dtype != torch.bool for t in flags)):
        raise ValueError(f"{what}: poses, edge data and scalars float32, edge ends int64, "
                         "masks bool")


def _edge_shapes(what, X, e_a, e_b, e_T, e_info, *per_edge):
    E = e_a.shape[0]
    if (X.dim() != 3 or tuple(X.shape[1:]) != (4, 4) or tuple(e_b.shape) != (E,)
            or tuple(e_T.shape) != (E, 4, 4) or tuple(e_info.shape) != (E, 6, 6)
            or any(tuple(t.shape) != (E,) for t in per_edge) or E < 1 or X.shape[0] < 1):
        raise ValueError(f"{what}: expected X (N, 4, 4), edge ends (E,), T (E, 4, 4), "
                         f"info (E, 6, 6) and per-edge (E,), got {tuple(X.shape)}, "
                         f"{tuple(e_a.shape)}, {tuple(e_T.shape)}, {tuple(e_info.shape)}")
    return X.shape[0], E


def pg_linearize(X, e_a, e_b, e_T, e_info, e_unc, e_mask, mu) -> EdgeBlocks:
    """Linearize every edge at the poses X (N, 4, 4): edge ends e_a, e_b
    (E,) int64, transforms e_T (E, 4, 4), information e_info (E, 6, 6),
    uncertain and mask flags (E,) bool, the line-process scale mu () float32."""
    N, E = _edge_shapes("pg_linearize", X, e_a, e_b, e_T, e_info, e_unc, e_mask)
    if X.device.type == "cpu":
        return pg_linearize_plain(X, e_a, e_b, e_T, e_info, e_unc, e_mask, mu)
    _check("pg_linearize", X.device, (X, e_T, e_info, mu), (e_a, e_b), (e_unc, e_mask))
    f32 = dict(dtype=torch.float32, device=X.device)
    out = EdgeBlocks(torch.empty((E, 6), **f32), torch.empty((E,), **f32),
                     torch.empty((E, 6, 6), **f32), torch.empty((E, 6, 6), **f32),
                     torch.empty((E, 6, 6), **f32), torch.empty((E, 6), **f32),
                     torch.empty((E, 6), **f32), torch.empty((E,), **f32))
    fn = _fn("pg_linearize_launch", 16, 2)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    cuda_build.count_launch("pg_linearize", (N, E))
    err = fn(X.data_ptr(), e_a.data_ptr(), e_b.data_ptr(), e_T.data_ptr(), e_info.data_ptr(),
             e_unc.data_ptr(), e_mask.data_ptr(), mu.data_ptr(),
             *(t.data_ptr() for t in out), N, E, stream)
    cuda_build.check(err, "pg_linearize")
    return out


def pg_assemble(blocks: EdgeBlocks, e_a, e_b, prior, damping
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The damped normal equations of one linearization: (H + damping
    diag(H) (6N, 6N), b (6N,), cost ()), with ``prior`` (N,) on H's
    diagonal (before the damping) and N = ``prior.shape[0]``."""
    E, N = e_a.shape[0], prior.shape[0]
    if (tuple(e_b.shape) != (E,) or tuple(prior.shape) != (N,) or damping.dim() != 0
            or tuple(blocks.H_ss.shape) != (E, 6, 6) or tuple(blocks.b_s.shape) != (E, 6)
            or tuple(blocks.cost.shape) != (E,) or tuple(blocks.w.shape) != (E,)
            or E < 1 or N < 1):
        raise ValueError("pg_assemble: expected blocks of E edges, edge ends (E,), prior "
                         f"(N,) and a scalar damping, got E = {E}, prior {tuple(prior.shape)}")
    if prior.device.type == "cpu":
        return pg_assemble_plain(blocks, e_a, e_b, prior, damping)
    parts = (blocks.H_ss, blocks.H_st, blocks.H_tt, blocks.b_s, blocks.b_t, blocks.cost,
             blocks.w)
    _check("pg_assemble", prior.device, (*parts, prior, damping), (e_a, e_b))
    f32 = dict(dtype=torch.float32, device=prior.device)
    H = torch.empty((6 * N, 6 * N), **f32)
    b = torch.empty((6 * N,), **f32)
    cost = torch.empty((), **f32)
    fn = _fn("pg_assemble_launch", 14, 2)
    stream = torch.cuda.current_stream(prior.device).cuda_stream
    cuda_build.count_launch("pg_assemble", (N, E))
    err = fn(*(t.data_ptr() for t in parts), e_a.data_ptr(), e_b.data_ptr(),
             prior.data_ptr(), damping.data_ptr(), H.data_ptr(), b.data_ptr(),
             cost.data_ptr(), N, E, stream)
    cuda_build.check(err, "pg_assemble")
    return H, b, cost


def pg_step(X, delta, e_a, e_b, e_T, e_info, w, cost, damping
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retract X (N, 4, 4) by delta (6N,), accept if the cost with weights w
    (E,) falls below ``cost`` (), and update ``damping`` (): returns the new
    (X, damping)."""
    N, E = _edge_shapes("pg_step", X, e_a, e_b, e_T, e_info, w)
    if tuple(delta.shape) != (6 * N,) or cost.dim() != 0 or damping.dim() != 0:
        raise ValueError(f"pg_step: expected delta ({6 * N},) and scalar cost and damping, "
                         f"got {tuple(delta.shape)}, {tuple(cost.shape)}, "
                         f"{tuple(damping.shape)}")
    if X.device.type == "cpu":
        return pg_step_plain(X, delta, e_a, e_b, e_T, e_info, w, cost, damping)
    _check("pg_step", X.device, (X, delta, e_T, e_info, w, cost, damping), (e_a, e_b))
    X_out = torch.empty_like(X)
    d_out = torch.empty_like(damping)
    fn = _fn("pg_step_launch", 11, 2)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    cuda_build.count_launch("pg_step", (N, E))
    err = fn(X.data_ptr(), delta.data_ptr(), e_a.data_ptr(), e_b.data_ptr(), e_T.data_ptr(),
             e_info.data_ptr(), w.data_ptr(), cost.data_ptr(), damping.data_ptr(),
             X_out.data_ptr(), d_out.data_ptr(), N, E, stream)
    cuda_build.check(err, "pg_step")
    return X_out, d_out
