"""One Gauss-Newton step of the fused ICP loops, and the pose applied before
each sweep.

The loops of ``registration._icp_gicp_fused_batch`` and
``_icp_p2l_fused_batch`` (the JAX package's loop bodies,
``open3d_slam_tpu/ops/registration.py:144-255``) run, per iteration,
``gn_apply`` (the source moved by the poses P, and for GICP its covariances
rotated), the sweep of K1 or K4 at P, then ``gn_step``: the statistics of
the sweep's (B, 8, 128) output, the stop test, and the next step from the
same normal equations.  The state (``gn_graph.GNState``) is (T, P, fit,
rmse, it, done): T the poses the statistics were taken at (the result), P
the poses the next sweep evaluates.  On CUDA tensors each wrapper launches
its hand-written kernel in ``csrc/gn_step.cu``; on CPU tensors it runs its
plain version; on any other device it raises.

- ``gn_step_plain`` is the chain the loops ran before the kernel
  (``registration._stats``, ``_solve6``, the retraction, dT @ P, the freeze
  and the stop test), so the CPU path computes what it did.  The kernel
  takes the solve in ``solve6_plain``'s order (``csrc/solve6.cuh``), at every
  B (the chain's B = 1 solve is cuSOLVER's or LAPACK's), and its own
  products: its poses are within float32 rounding of the chain's, its
  statistics and stop test the chain's operations.
- ``gn_apply_plain`` is ``se3.transform_points`` and
  ``cuda_gicp.rotate_cov6``, whose products accumulate each entry as a
  chain of fused multiply-adds in ascending order; the kernel takes the
  same chain with explicit ones, and gives their bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from open3d_slam_torch.ops import cuda_build, cuda_gicp, cuda_solve6
from open3d_slam_torch.ops.gn_graph import GNState
from open3d_slam_torch.utils import se3

_JITTER = 1e-6


def solve6_chain(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    """The loops' earlier 6x6 solve (the JAX ``_solve6``): Tikhonov jitter
    1e-6 * trace/6, then Cholesky, no error check (so no host sync).  On the
    card a batch of more than one went to ``cuda_solve6.solve6`` (MAGMA's
    batched solve synchronises and cannot be captured into a CUDA graph);
    one system to cuSOLVER."""
    if JtJ.device.type == "cuda" and JtJ.shape[0] > 1:
        return cuda_solve6.solve6(JtJ, Jtr)
    tr = JtJ.diagonal(dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / 6.0, min=1e-12)
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + (_JITTER * scale)[..., None, None] * eye
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(-Jtr[..., None], L)[..., 0]


def euler_xyz_transform(x: torch.Tensor) -> torch.Tensor:
    """6-vector (alpha, beta, gamma, tx, ty, tz) -> 4x4 via Rz*Ry*Rx + t:
    Open3D's ``TransformVector6dToMatrix4d``, the retraction of its
    point-to-plane solver."""
    R = se3.rpy_to_matrix(x[..., 0], x[..., 1], x[..., 2])
    return se3.make_transform(R, x[..., 3:6])


def stats(out: torch.Tensor, n_src: torch.Tensor):
    """(JtJ, Jtr, fitness, rmse) of a fused kernel's (B, 8, 128) output."""
    JtJ, Jtr, n_in, d2s = cuda_gicp.unpack(out)
    fit = n_in / torch.clamp(n_src, min=1.0)
    rmse = torch.sqrt(d2s / torch.clamp(n_in, min=1.0))
    return JtJ, Jtr, fit, rmse


def gn_step_plain(out: torch.Tensor, n_src: torch.Tensor, P: torch.Tensor,
                  prev: Optional[GNState], exp_retraction: bool, relative_fitness: float = 0.0,
                  relative_rmse: float = 0.0, delta: Optional[torch.Tensor] = None) -> GNState:
    """The kernel's function as the loops' earlier chain computed it: the
    state after the step (and the solve's 6-vectors into ``delta``)."""
    JtJ, Jtr, fit, rmse = stats(out, n_src)
    b = P.shape[0]
    if prev is None:
        it = torch.zeros(b, dtype=torch.int32, device=P.device)
        done = torch.zeros(b, dtype=torch.bool, device=P.device)
    else:
        conv = ((prev.fit - fit).abs() < relative_fitness) & \
            ((prev.rmse - rmse).abs() < relative_rmse)
        it = prev.it + (~prev.done).to(torch.int32)
        done = prev.done | conv
    x = solve6_chain(JtJ, Jtr)
    if delta is not None:
        delta.copy_(x)
    dT = (se3.se3_exp if exp_retraction else euler_xyz_transform)(x)
    P_next = torch.where(done[:, None, None], P, dT @ P)
    return GNState(P, P_next, fit, rmse, it, done)


def _launch_gn_step(out, n_src, P, prev, exp_retraction, relative_fitness, relative_rmse,
                    delta):
    lib = cuda_build.load("gn_step")
    fn = lib.gn_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p,
                   ctypes.c_longlong] + [ctypes.c_void_p] * 12 +
                   [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    b, dev = P.shape[0], P.device
    T_out = torch.empty((b, 4, 4), dtype=torch.float32, device=dev)
    P_out = torch.empty_like(T_out)
    fit, rmse = (torch.empty(b, dtype=torch.float32, device=dev) for _ in range(2))
    it = torch.empty(b, dtype=torch.int32, device=dev)
    done = torch.empty(b, dtype=torch.bool, device=dev)
    ins = (0, 0, 0, 0) if prev is None else tuple(
        t.data_ptr() for t in (prev.fit, prev.rmse, prev.it, prev.done))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(out.data_ptr(), *out.stride(), n_src.data_ptr(),
             n_src.stride(0) if n_src.dim() and n_src.shape[0] > 1 else 0, P.data_ptr(),
             *ins, T_out.data_ptr(), P_out.data_ptr(), fit.data_ptr(), rmse.data_ptr(),
             it.data_ptr(), done.data_ptr(), 0 if delta is None else delta.data_ptr(), b,
             int(exp_retraction), relative_fitness, relative_rmse, stream)
    cuda_build.check(err, "gn_step")
    return GNState(T_out, P_out, fit, rmse, it, done)


def gn_step(out: torch.Tensor, n_src: torch.Tensor, P: torch.Tensor,
            prev: Optional[GNState], exp_retraction: bool, relative_fitness: float = 0.0,
            relative_rmse: float = 0.0, delta: Optional[torch.Tensor] = None) -> GNState:
    """The step after a sweep at the poses P (B, 4, 4): ``out`` the fused
    kernel's (B, 8, 128) output there (any strides), ``n_src`` the valid
    source points, () or (B,).  ``prev`` is the state whose P was swept, or
    None at the loop's start (no stop test; it 0, done False).  Returns the
    next ``GNState`` (T = P, P = the next poses: dT P, or P where done).
    ``delta``, when given, a contiguous (B, 6) float32 tensor on P's
    device, receives the solve's 6-vectors (the loops pass none).  The
    retraction is the SE(3) exponential, or the Euler-XYZ transform."""
    dev, b = P.device, P.shape[0]
    if (out.dim() != 3 or tuple(out.shape) != (b, 8, 128) or tuple(P.shape) != (b, 4, 4)
            or n_src.numel() not in (1, b) or b < 1):
        raise ValueError("gn_step: expected out (B, 8, 128), P (B, 4, 4) and n_src () or "
                         f"(B,), got {tuple(out.shape)}, {tuple(P.shape)}, "
                         f"{tuple(n_src.shape)}")
    if delta is not None and (tuple(delta.shape) != (b, 6) or delta.device != dev
                              or delta.dtype != torch.float32 or not delta.is_contiguous()):
        raise ValueError(f"gn_step: delta must be a contiguous float32 (B, 6) tensor on {dev}")
    if dev.type == "cpu":
        return gn_step_plain(out, n_src, P, prev, exp_retraction, relative_fitness,
                             relative_rmse, delta)
    if dev.type != "cuda":
        raise RuntimeError(f"gn_step: no kernel for device {dev}")
    state = () if prev is None else (prev.fit, prev.rmse, prev.it, prev.done)
    dtypes = (torch.float32,) * 5 + (torch.int32, torch.bool)   # zip stops at the start's 3
    if (any(t.device != dev or t.dtype != d for t, d in zip((out, n_src, P) + state, dtypes))
            or not all(t.is_contiguous() for t in (P,) + state)
            or any(tuple(t.shape) != (b,) for t in state)):
        raise ValueError(f"gn_step: float32 out, n_src and P (contiguous), and a "
                         f"contiguous (B,) state, all on {dev}")
    cuda_build.count_launch("gn_step", (b,))
    return _launch_gn_step(out, n_src.reshape(-1), P, prev, exp_retraction,
                           relative_fitness, relative_rmse, delta)


def gn_apply_plain(T: torch.Tensor, points: torch.Tensor,
                   cov6: Optional[torch.Tensor] = None):
    """The source at the poses T (B, 4, 4): points (M, 3) or (B or 1, M, 3)
    -> R p + t (B, M, 3), and cov6 (B or 1, M, 6) -> the entries of R C R^T
    (B, M, 6) (None without covariances), contiguous: ``se3.transform_points``
    and ``cuda_gicp.rotate_cov6``, the loops' earlier chain, whose products
    accumulate each entry as the kernel does (a fused multiply-add a term,
    in ascending order)."""
    moved = se3.transform_points(T, points).contiguous()
    if cov6 is None:
        return moved, None
    return moved, cuda_gicp.rotate_cov6(T[..., :3, :3], cov6).contiguous()


def _vec_ok(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_gn_apply(T, points, cov6):
    lib = cuda_build.load("gn_step")
    fn = lib.gn_apply_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 +
                   [ctypes.c_void_p])
    b, m, dev = T.shape[0], points.shape[-2], T.device
    moved = torch.empty((b, m, 3), dtype=torch.float32, device=dev)
    rot = None if cov6 is None else torch.empty((b, m, 6), dtype=torch.float32, device=dev)
    pb = points.stride(0) if points.dim() == 3 and points.shape[0] > 1 else 0
    cb = 0 if cov6 is None or cov6.shape[0] == 1 else cov6.stride(0)
    vec = (m % 4 == 0 and pb % 4 == 0 and cb % 4 == 0
           and _vec_ok(points, moved, *(() if cov6 is None else (cov6, rot))))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(T.data_ptr(), points.data_ptr(), pb, 0 if cov6 is None else cov6.data_ptr(), cb,
             moved.data_ptr(), 0 if rot is None else rot.data_ptr(), b, m, int(vec), stream)
    cuda_build.check(err, "gn_apply")
    return moved, rot


def gn_apply(T: torch.Tensor, points: torch.Tensor, cov6: Optional[torch.Tensor] = None):
    """The source moved by the poses T (B, 4, 4) for the next sweep: points
    (M, 3) or (B or 1, M, 3) float32 -> (B, M, 3) contiguous, and cov6
    (B or 1, M, 6) -> R C R^T's entries (B, M, 6) contiguous, or None.  A
    batch element's rows are contiguous; the batch may have any stride
    (0 for one cloud that every pose shares)."""
    dev, b = T.device, T.shape[0]
    m = points.shape[-2]
    if (tuple(T.shape) != (b, 4, 4) or points.shape[-1] != 3 or points.dim() not in (2, 3)
            or (points.dim() == 3 and points.shape[0] not in (1, b))
            or (cov6 is not None and (cov6.dim() != 3 or cov6.shape[0] not in (1, b)
                                      or tuple(cov6.shape[1:]) != (m, 6)))):
        raise ValueError(f"gn_apply: expected T (B, 4, 4), points (M, 3) or (B or 1, M, 3) "
                         f"and cov6 (B or 1, M, 6), got {tuple(T.shape)}, "
                         f"{tuple(points.shape)}, {None if cov6 is None else tuple(cov6.shape)}")
    if dev.type == "cpu":
        return gn_apply_plain(T, points, cov6)
    if dev.type != "cuda":
        raise RuntimeError(f"gn_apply: no kernel for device {dev}")
    ins = (T, points) + (() if cov6 is None else (cov6,))
    rows = [(points, 3)] + ([] if cov6 is None else [(cov6, 6)])
    if (any(t.device != dev or t.dtype != torch.float32 for t in ins)
            or not T.is_contiguous()
            or any(t.stride()[-2:] != (w, 1) for t, w in rows)):
        raise ValueError(f"gn_apply: float32 T (contiguous), points and cov6 (contiguous "
                         f"rows of each batch element), all on {dev}")
    cuda_build.count_launch("gn_apply", (b, m, 3 if cov6 is None else 9))
    return _launch_gn_apply(T, points, cov6)
