"""The weighted Kabsch step of point-to-point ICP.

``p2p_step`` computes the JAX package's ``registration._p2p_step`` (the
weighted centroids, the 3x3 cross-covariance about them, its SVD, the
reflection sign and R, t) for a batch of hypotheses: on CUDA tensors it
launches the hand-written kernel in ``csrc/p2p_step.cu``; on CPU tensors it
runs ``p2p_step_plain``, the same function in plain PyTorch (the moments,
``torch.linalg.svd``, ``torch.linalg.det``).  The point-to-point loop
(``registration.batched_icp_point_to_point``) takes it on every iteration;
on the card the library route would synchronise with the host for its SVD
and could not be captured into the loop's CUDA graph (``ops/gn_graph.py``).

Both take the SVD of the float32 H in float64 (the kernel by Jacobi
rotations, the plain version through LAPACK or cuSOLVER) and round R to
float32, and both sum the moments in float32, in other orders: they give
rotations a few float32 roundings apart wherever the step is determined (H
of rank 2 or 3).  With collinear inliers (rank 1) R is not determined by H,
and the kernel returns the smallest rotation that aligns the two lines
(``csrc/p2p_step.cu``).  The JAX package's float32 SVD agrees with either to
about one rounding of R's entries on the replays' moments.
"""
from __future__ import annotations

import ctypes

import torch

from open3d_slam_torch.ops import cuda_build

# The kernel runs a thread-block cluster of ``cluster_size(M)`` CTAs per
# hypothesis, each on a contiguous chunk of the points.
CLUSTER_CHUNK = 2048     # points a CTA takes before the cluster grows
MAX_CLUSTER = 8          # the portable cluster size


def cluster_size(m: int) -> int:
    """CTAs per hypothesis for M = ``m`` points: min(8, ceil(M / 2048)),
    at least 1.  It depends on M alone, never on B, so a hypothesis's sums
    run in the same order alone as in any batch."""
    return max(1, min(MAX_CLUSTER, -(-m // CLUSTER_CHUNK)))


def p2p_moments(pts: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Weighted centroids and cross-covariance of the Kabsch step: pts, q
    (B, M, 3), w (B, M) -> H (B, 3, 3), p_bar, q_bar (B, 3)."""
    wf = w.to(pts.dtype)[..., None]
    n = torch.clamp(wf.sum(-2), min=1.0)
    p_bar = (pts * wf).sum(-2) / n
    q_bar = (q * wf).sum(-2) / n
    P = (pts - p_bar[..., None, :]) * wf
    Q = q - q_bar[..., None, :]
    return P.transpose(-1, -2) @ Q, p_bar, q_bar


def p2p_step_plain(pts: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: pts, q (B, M, 3) float32, w
    (B, M) bool -> dT (B, 4, 4), the weighted Kabsch step (Umeyama without
    scaling, as Open3D) through ``torch.linalg.svd``: R = V D U^T with D =
    diag(1, 1, sign(det(V U^T))).  The SVD and R are float64, as the
    kernel's, then rounded to float32."""
    H, p_bar, q_bar = p2p_moments(pts, q, w)
    U, _, Vh = torch.linalg.svd(H.to(torch.float64))
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = ((V * D[..., None, :]) @ Ut).to(H.dtype)
    dT = torch.zeros((*H.shape[:-2], 4, 4), dtype=H.dtype, device=H.device)
    dT[..., :3, :3] = R
    dT[..., :3, 3] = q_bar - (R @ p_bar[..., None])[..., 0]
    dT[..., 3, 3] = 1.0
    return dT


def _launch_p2p(pts: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    lib = cuda_build.load("p2p_step")
    fn = lib.p2p_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    b, m, _ = pts.shape
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = fn(pts.data_ptr(), q.data_ptr(), w.data_ptr(), out.data_ptr(), b, m,
             cluster_size(m), stream)
    cuda_build.check(err, "p2p_step")
    return out


def p2p_step(pts: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weighted Kabsch step of each hypothesis: the points at the current
    pose pts (B, M, 3), their correspondences q (B, M, 3), float32, and the
    inlier flags w (B, M) bool -> dT (B, 4, 4), the update applied on the
    left.  No inliers give dT = I."""
    dev = pts.device
    if (pts.dim() != 3 or pts.shape[-1] != 3 or tuple(q.shape) != tuple(pts.shape)
            or tuple(w.shape) != tuple(pts.shape[:2]) or pts.shape[0] < 1):
        raise ValueError("p2p_step: expected pts and q (B, M, 3) and w (B, M) with B >= 1, "
                         f"got {tuple(pts.shape)}, {tuple(q.shape)} and {tuple(w.shape)}")
    if dev.type == "cpu":
        return p2p_step_plain(pts, q, w)
    if dev.type != "cuda":
        raise RuntimeError(f"p2p_step: no kernel for device {dev}")
    if (q.device != dev or w.device != dev or pts.dtype != torch.float32
            or q.dtype != torch.float32 or w.dtype != torch.bool
            or not all(t.is_contiguous() for t in (pts, q, w))):
        raise ValueError(f"p2p_step: pts and q contiguous float32 and w contiguous bool, "
                         f"all on {dev}")
    cuda_build.count_launch("p2p_step", tuple(w.shape))
    return _launch_p2p(pts, q, w)
