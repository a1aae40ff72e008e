"""The batched 6x6 jittered Cholesky solve of a Gauss-Newton step.

``solve6`` computes the JAX package's ``registration._solve6`` (trace
jitter, Cholesky, the two triangular solves) for a batch of (B, 6, 6) normal
equations: on CUDA tensors it launches the hand-written kernel in
``csrc/solve6.cu``; on CPU tensors it runs ``solve6_plain``, the same
operations in the same order in plain PyTorch (bit-equal to the kernel on
the card).  The loops' step kernel (``csrc/gn_step.cu``) runs the same solve
(``csrc/solve6.cuh``) inside it; this wrapper launches the solve alone:
``cuda_gn_step.solve6_chain``, the plain version of that step, takes it for
B > 1 on the card, where the library route (MAGMA's batched potrs)
synchronises and cannot be captured into a CUDA graph (``ops/gn_graph.py``).
"""
from __future__ import annotations

import ctypes

import torch

from open3d_slam_torch.ops import cuda_build

_JITTER = 1e-6


def solve6_plain(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    """JtJ (B, 6, 6), Jtr (B, 6) -> the step x (B, 6) of (JtJ + jitter) x =
    -Jtr, in the kernel's order of operations: the trace summed in index
    order and times the float nearest 1/6 (PyTorch divides a CUDA tensor by a
    scalar so; on the CPU it divides), a left-looking Cholesky, forward then
    back substitution."""
    A = [[JtJ[:, i, j] for j in range(6)] for i in range(6)]
    tr = A[0][0]
    for i in range(1, 6):
        tr = tr + A[i][i]
    jitter = _JITTER * torch.clamp(tr * (1.0 / 6.0), min=1e-12)
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = A[j][j] + jitter
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, 6):
            t = A[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t / L[j][j]
    y = []
    for i in range(6):
        s = -Jtr[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _launch_solve6(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    lib = cuda_build.load("solve6")
    fn = lib.solve6_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] +
                   [ctypes.c_longlong] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_void_p])
    b = JtJ.shape[0]
    out = torch.empty((b, 6), dtype=torch.float32, device=JtJ.device)
    stream = torch.cuda.current_stream(JtJ.device).cuda_stream
    err = fn(JtJ.data_ptr(), *JtJ.stride(), Jtr.data_ptr(), *Jtr.stride(),
             out.data_ptr(), b, stream)
    cuda_build.check(err, "solve6")
    return out


def solve6(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    """The jittered 6x6 solve of ``registration._solve6`` for JtJ (B, 6, 6)
    and Jtr (B, 6), float32, any strides (the views ``cuda_gicp.unpack``
    gives).  Returns x (B, 6)."""
    dev = JtJ.device
    if (JtJ.dim() != 3 or tuple(JtJ.shape[1:]) != (6, 6) or Jtr.dim() != 2
            or tuple(Jtr.shape) != (JtJ.shape[0], 6) or JtJ.shape[0] < 1):
        raise ValueError("solve6: expected JtJ (B, 6, 6) and Jtr (B, 6) with B >= 1, "
                         f"got {tuple(JtJ.shape)} and {tuple(Jtr.shape)}")
    if dev.type == "cpu":
        return solve6_plain(JtJ, Jtr)
    if dev.type != "cuda":
        raise RuntimeError(f"solve6: no kernel for device {dev}")
    if (Jtr.device != dev or JtJ.dtype != torch.float32
            or Jtr.dtype != torch.float32):
        raise ValueError(f"solve6: JtJ and Jtr must be float32 tensors on {dev}")
    cuda_build.count_launch("solve6", (JtJ.shape[0],))
    return _launch_solve6(JtJ, Jtr)
