"""Exact brute-force nearest neighbour: kernel K3 and its plain version.

Port of ``open3d_slam_tpu.ops.pallas_knn``.  ``nn_argmin`` is the counterpart
of the Pallas kernel of the same name: on CUDA tensors it launches the
hand-written kernel in ``csrc/knn.cu``; on CPU tensors it runs
``nn_argmin_plain``, the same function in plain PyTorch.  Both take the
expansion form d2 = (|q|^2 + |t|^2) - 2 q.t, rounded operation by operation
in the JAX operand order, with invalid targets masked by |t|^2 = +inf, and
break ties to the lowest target index.  The caller recomputes the winner's
exact distance (``ops/hashgrid.query_nearest``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from open3d_slam_torch.ops import cuda_build

_PLAIN_CHUNK = 512


def squared_norms(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 per row of (K, 3), summed in a fixed order (x, then y, then z)."""
    return p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]


def nn_argmin_plain(query_points: torch.Tensor, q2: torch.Tensor,
                    target_points_t: torch.Tensor, target_sq_masked: torch.Tensor):
    """Plain PyTorch version of the kernel, chunked over queries (at
    32768 x 65536 the full matrix is 8.6 GB).  Elementwise operations only:
    a matmul would sum the dot product in another order.  torch.argmin
    returns the first minimum.  Returns (idx (M,) int32, d2 (M,) float32)."""
    tx, ty, tz = target_points_t[0][None, :], target_points_t[1][None, :], \
        target_points_t[2][None, :]
    t2 = target_sq_masked[None, :]
    idx, best = [], []
    for s in range(0, query_points.shape[0], _PLAIN_CHUNK):
        q = query_points[s:s + _PLAIN_CHUNK]
        dot = q[:, 0:1] * tx + q[:, 1:2] * ty + q[:, 2:3] * tz
        d2 = (q2[s:s + _PLAIN_CHUNK, None] + t2) - 2.0 * dot
        a = torch.argmin(d2, dim=1)
        idx.append(a.to(torch.int32))
        best.append(torch.gather(d2, 1, a[:, None])[:, 0])
    return torch.cat(idx), torch.cat(best)


def _launch_knn(q, q2, t_t, t2):
    lib = cuda_build.load("knn")
    fn = lib.knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    m, n = q.shape[0], t_t.shape[1]
    dev = q.device
    q_blocks = -(-m // lib.knn_block_size())
    n_tiles = max(1, -(-n // lib.knn_tile_size()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, math.ceil(4 * sms / q_blocks))
    tiles_per_split = max(1, -(-n_tiles // want))
    splits = -(-n_tiles // tiles_per_split)
    part_d2 = torch.empty((splits, m), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, m), dtype=torch.int32, device=dev)
    out_idx = torch.empty((m,), dtype=torch.int32, device=dev)
    out_d2 = torch.empty((m,), dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), q2.data_ptr(), t_t.data_ptr(), t2.data_ptr(),
             part_d2.data_ptr(), part_idx.data_ptr(), out_idx.data_ptr(),
             out_d2.data_ptr(), m, n, splits, tiles_per_split,
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "nn_argmin")
    return out_idx, out_d2


def knn_inputs(query_points: torch.Tensor, target_points_t: torch.Tensor,
               target_sq_masked: torch.Tensor):
    """What the kernel reads: contiguous float32 queries (M, 3), their |q|^2
    (M,) (computed here, as the JAX wrapper computes it around its Pallas
    call), transposed targets (3, N) and masked |t|^2 (N,)."""
    q = query_points.to(torch.float32).contiguous()
    return (q, squared_norms(q).contiguous(),
            target_points_t.to(torch.float32).contiguous(),
            target_sq_masked.reshape(-1).to(torch.float32).contiguous())


def nn_argmin(query_points: torch.Tensor, target_points_t: torch.Tensor,
              target_sq_masked: torch.Tensor):
    """Running argmin of squared distances (the JAX kernel's signature,
    without its block-size constraints).

    query_points (M, 3); target_points_t (3, N), transposed; target_sq_masked
    (N,) or (1, N): |t|^2 with +inf at invalid slots.  Returns (best_idx (M,)
    int32, best_d2_approx (M,) float32)."""
    dev = query_points.device
    inputs = knn_inputs(query_points, target_points_t, target_sq_masked)
    if dev.type == "cpu":
        return nn_argmin_plain(*inputs)
    if dev.type != "cuda":
        raise RuntimeError(f"nn_argmin: no kernel for device {dev}")
    for t in inputs:
        if t.device != dev:
            raise ValueError(f"nn_argmin: every input must lie on {dev}")
    if inputs[2].shape[0] != 3 or inputs[3].shape[0] != inputs[2].shape[1]:
        raise ValueError("nn_argmin: targets must be (3, N) with (N,) norms")
    cuda_build.count_launch("nn_argmin", (inputs[0].shape[0], inputs[2].shape[1]))
    return _launch_knn(*inputs)
