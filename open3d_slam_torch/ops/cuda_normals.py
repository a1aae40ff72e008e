"""Radius-neighbourhood PCA moments for normals: kernel K2 and what surrounds it.

Port of ``open3d_slam_tpu.ops.pallas_normals``.  ``radius_moments_at`` is the
counterpart of the Pallas kernel of the same name: on a CUDA tensor it
launches the hand-written kernel in ``csrc/normals.cu``; on a CPU tensor it
runs ``radius_moments_plain``, the same function in plain PyTorch.

Hybrid (radius + max_nn) semantics are exact, as in the JAX package: a
k-th-neighbour prepass (``kth_neighbor_d2_at``) gives each query its own
radius min(r, d_k), and the moments kernel sums over that neighbourhood.
The prepass is plain XLA in the JAX package and stays plain PyTorch here: a
chunked full-float32 matmul in the expansion form |q|^2 + |t|^2 - 2 q.t,
then ``torch.topk``.  It is EXACT, equal to the JAX function with
``exact=True``; PyTorch has no counterpart of ``jax.lax.approx_min_k``,
which the JAX package uses by default on the TPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from open3d_slam_torch.ops import cuda_build

_BIG = 3.0e38
_PLAIN_CHUNK = 1024


def radius_moments_plain(q: torch.Tensor, p: torch.Tensor, maskf: torch.Tensor,
                         feats: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: centred queries (M, 3), centred
    support (N, 3), support validity (N,) float, features (N, 16), per-query
    r^2 (M,) -> (M, 16).  Chunked over queries to bound memory."""
    out = []
    for s in range(0, q.shape[0], _PLAIN_CHUNK):
        qc = q[s:s + _PLAIN_CHUNK]
        d0 = qc[:, 0:1] - p[None, :, 0]
        d1 = qc[:, 1:2] - p[None, :, 1]
        d2_ = qc[:, 2:3] - p[None, :, 2]
        d2 = d0 * d0 + d1 * d1 + d2_ * d2_
        w = ((d2 <= r2[s:s + _PLAIN_CHUNK, None]) &
             (maskf[None, :] > 0.0)).to(torch.float32)
        out.append(w @ feats)
    return torch.cat(out, dim=0)


def _launch_moments(q, p, maskf, feats, r2) -> torch.Tensor:
    lib = cuda_build.load("normals")
    fn = lib.radius_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    m, n = q.shape[0], p.shape[0]
    tile = lib.moments_tile_size()
    q_blocks = -(-m // lib.moments_block_size())
    n_tiles = max(1, -(-n // tile))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    want = max(1, math.ceil(4 * sms / q_blocks))
    tiles_per_split = max(1, -(-n_tiles // want))
    splits = -(-n_tiles // tiles_per_split)
    part = torch.empty((splits, m, 10), dtype=torch.float32, device=q.device)
    out = torch.empty((m, 16), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), p.data_ptr(), maskf.data_ptr(), feats.data_ptr(),
             r2.data_ptr(), part.data_ptr(), out.data_ptr(), m, n, splits,
             tiles_per_split, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "radius_moments")
    return out


def moment_inputs(query_points: torch.Tensor, points: torch.Tensor,
                  mask: torch.Tensor, radius):
    """What the kernel reads, as the JAX package builds it around its Pallas
    call: queries and support centred on the support centroid, the support
    validity as float, the 16 support features [1, x, y, z, xx, xy, xz, yy,
    yz, zz, 0...] and the per-query r^2.  Returns (q, p, maskf, feats, r2)."""
    m, n = query_points.shape[0], points.shape[0]
    dev = points.device
    maskf = mask.to(torch.float32).contiguous()
    cnt = torch.clamp(maskf.sum(), min=1.0)
    centroid = (points * maskf[:, None]).sum(dim=0) / cnt
    p = (points - centroid).contiguous()
    q = (query_points - centroid).contiguous()
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    feats = torch.cat([torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                                    x * z, y * y, y * z, z * z], dim=1),
                       torch.zeros((n, 6), dtype=torch.float32, device=dev)],
                      dim=1).contiguous()
    if not torch.is_tensor(radius):
        radius = torch.full((), float(radius), dtype=torch.float32, device=dev)
    r2 = (radius.to(torch.float32) ** 2).expand(m).contiguous()
    return q, p, maskf, feats, r2


def radius_moments_at(query_points: torch.Tensor, points: torch.Tensor,
                      mask: torch.Tensor, radius) -> torch.Tensor:
    """Radius-neighbourhood moments of ``query_points`` (M, 3) against a
    support cloud ``points`` (N, 3) / ``mask`` (N,); ``radius`` scalar or
    per-query (M,).  Returns (M, 16): col 0 = neighbour count, cols 1:4 =
    sums of positions, cols 4:10 = sums of (xx, xy, xz, yy, yz, zz), all in
    support-centroid-centred coordinates."""
    dev = points.device
    inputs = moment_inputs(query_points, points, mask, radius)
    if dev.type == "cpu":
        return radius_moments_plain(*inputs)
    if dev.type != "cuda":
        raise RuntimeError(f"radius_moments_at: no kernel for device {dev}")
    for t in (query_points, points, mask):
        if t.device != dev:
            raise ValueError(f"radius_moments_at: every input must lie on {dev}")
    cuda_build.count_launch("radius_moments_at",
                            (query_points.shape[0], points.shape[0]))
    return _launch_moments(*inputs)


def plain_disagreement(got: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                       maskf: torch.Tensor, feats: torch.Tensor,
                       r2: torch.Tensor) -> dict:
    """How far a kernel output (M, 16) lies from the plain version on the
    same inputs (those of ``moment_inputs``), entry by entry:

    - ``count_equal``: the neighbour counts are equal (both sides test the
      same term-by-term rounded distances, so they must be);
    - ``moments``: the largest |d moment| over the sum of |feature| over the
      same neighbours, which bounds the rounding of a sum taken in another
      order (the zero columns 10-15 must be equal);
    - ``max_abs_err``: the largest |got - want| of all;
    - ``neighbours``: the number of (query, support) pairs within radius."""
    want = radius_moments_plain(q, p, maskf, feats, r2).double()
    scale = radius_moments_plain(q, p, maskf, feats.abs(), r2).double()
    err = (got.double() - want).abs()
    return {
        "count_equal": bool(torch.equal(got[:, 0].double(), want[:, 0])),
        "moments": float((err / scale.clamp(min=torch.finfo(torch.float32).tiny)).max()),
        "max_abs_err": float(err.max()),
        "neighbours": int(want[:, 0].sum()),
    }


def radius_moments(points: torch.Tensor, mask: torch.Tensor, radius) -> torch.Tensor:
    """All-pairs moments of a cloud against itself."""
    return radius_moments_at(points, points, mask, radius)


def kth_neighbor_d2_at(query_points: torch.Tensor, points: torch.Tensor,
                       mask: torch.Tensor, k: int, chunk: int = 2048) -> torch.Tensor:
    """Per-query squared distance to the k-th nearest valid SUPPORT point
    (the query counts when it is in the support), expansion form, exact."""
    m = query_points.shape[0]
    k = min(k, points.shape[0])
    t2 = torch.where(mask, (points * points).sum(dim=1),
                     torch.full_like(points[:, 0], float("inf")))
    pt = points.t().contiguous()
    out = []
    for s in range(0, m, chunk):
        q = query_points[s:s + chunk]
        q2 = (q * q).sum(dim=1)
        d2 = q2[:, None] + t2[None, :] - 2.0 * (q @ pt)
        out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True).values[:, k - 1])
    return torch.clamp(torch.cat(out), min=0.0)


def kth_neighbor_d2(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    return kth_neighbor_d2_at(points, points, mask, k)


def hybrid_radius(radius, dk2: torch.Tensor) -> torch.Tensor:
    """Per-point hybrid radius min(r, d_k), inflated by (1 + 1e-5): d_k comes
    from the expansion form while the kernel tests the difference form, and
    the two disagree in the last ulps; the inflation keeps the k-th
    neighbour inside."""
    r2 = torch.minimum(torch.full((), float(radius), dtype=torch.float32,
                                  device=dk2.device) ** 2, dk2)
    return torch.sqrt(r2 * (1.0 + 1e-5) + 1e-12)


def moments_to_covariance(mom: torch.Tensor):
    """(N, 16) raw moments -> (count (N,), covariance (N, 3, 3))."""
    cnt = mom[:, 0]
    c = torch.clamp(cnt, min=1.0)
    mu = mom[:, 1:4] / c[:, None]
    exx, exy, exz = mom[:, 4] / c, mom[:, 5] / c, mom[:, 6] / c
    eyy, eyz, ezz = mom[:, 7] / c, mom[:, 8] / c, mom[:, 9] / c
    cxx = exx - mu[:, 0] * mu[:, 0]
    cxy = exy - mu[:, 0] * mu[:, 1]
    cxz = exz - mu[:, 0] * mu[:, 2]
    cyy = eyy - mu[:, 1] * mu[:, 1]
    cyz = eyz - mu[:, 1] * mu[:, 2]
    czz = ezz - mu[:, 2] * mu[:, 2]
    cov = torch.stack([torch.stack([cxx, cxy, cxz], -1),
                       torch.stack([cxy, cyy, cyz], -1),
                       torch.stack([cxz, cyz, czz], -1)], dim=-2)
    return cnt, cov
