"""Radius-neighbourhood PCA moments for normals: kernel K2 and what surrounds it.

Port of ``open3d_slam_tpu.ops.pallas_normals``.  K2 is two hand-written
kernels in ``csrc/normals.cu``, each with its plain PyTorch version beside
it (a CPU tensor runs the plain version, a CUDA tensor the kernel):

- ``kth_neighbor_d2_within``: the hybrid-radius prepass, per query
  min(r^2, d_k^2), where d_k^2 is the k-th smallest squared distance to a
  valid support point (the query counts when it is in the support) in the
  JAX package's own form (``kth_neighbor_d2_at`` with ``exact=True``): the
  expansion |q|^2 + |t|^2 - 2 q.t on the coordinates as given, the dot as a
  matrix product rounds it.  ``hybrid_radius`` turns it into the query's
  own radius min(r, d_k).  Only support points within r can change a value
  capped at r^2, which is what lets the kernel skip tiles.
- ``radius_moments_at``: the counterpart of the Pallas kernel of the same
  name, the sums of [1, x, y, z, xx, xy, xz, yy, yz, zz] over the valid
  support points within each query's radius, in the difference form on
  coordinates centred on the support centroid.

Both kernels read one ``NormalsLayout`` per normals call
(``normals_layout``): the support in Morton order with a box per tile
(``nn_layout.target_layout``), the queries' Morton order, and the support
centroid, which the moments kernel subtracts itself, rounding as the plain
version's ``points - centroid`` does.

Why the expansion form: at sensor range it rounds d^2 by ~ulp(|q|^2)
(6e-5 m^2 at 30 m), far more than ``hybrid_radius``'s 1e-5 inflation
absorbs, so an exact difference-form d_k changes which boundary neighbour
a query keeps against the JAX package, and the replay, which is chaotic,
moves by millimetres after two scans.  The port keeps the JAX function.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from open3d_slam_torch.ops import cuda_build, nn_layout

_PLAIN_CHUNK = 1024
# Query rows per chunk of the plain prepass: (chunk, N) distances at once.
_PLAIN_PAIRS = 1 << 25
_WARPS_PER_SM = 16       # sweep warps a K2 launch aims for per SM
# Splits of a query group's tiles, each with its partial result.  Every
# prepass split also sweeps the tiles that overlap its group's box, so the
# prepass takes fewer.
_KTH_MAX_SPLITS = 8
_MOMENTS_MAX_SPLITS = 32
KTH_MAX_K = 32           # the largest k of the prepass kernel (k-lists in registers)


class NormalsLayout(NamedTuple):
    centroid: torch.Tensor          # (3,) the valid support's centroid
    target: nn_layout.TargetLayout  # the support in Morton order, as given
    query_order: torch.Tensor       # (M,) int32 Morton order of the queries
    # The call's (query_points, points, mask) the layout was made with, and
    # their version counters then.
    arrays: Tuple[torch.Tensor, ...] = ()
    versions: Tuple[int, ...] = ()


def support_centroid(points: torch.Tensor, mask: torch.Tensor):
    """(centroid (3,), validity as float32 (N,)) of the support, as the JAX
    package centres it around its Pallas call."""
    maskf = mask.to(torch.float32).contiguous()
    cnt = torch.clamp(maskf.sum(), min=1.0)
    return (points * maskf[:, None]).sum(dim=0) / cnt, maskf


def normals_layout(query_points: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
                   query_mask: Optional[torch.Tensor] = None) -> NormalsLayout:
    """The layout both K2 kernels read, made once per normals call.  For a
    cloud against itself (``query_points is points``) the query order is the
    support's own Morton order; otherwise the queries are ordered with
    ``query_mask`` (default all valid) putting the valid ones first.  Every
    query is in the order: the kernels compute every row, as the plain
    versions do."""
    centroid, _ = support_centroid(points, mask)
    target = nn_layout.target_layout(points, mask)
    if query_points is points:
        order = target.order
    else:
        qv = (torch.ones(query_points.shape[0], dtype=torch.bool, device=points.device)
              if query_mask is None else query_mask)
        order = nn_layout.query_order(query_points, qv)
    arrays = (query_points, points, mask)
    return NormalsLayout(centroid.contiguous(), target, order, arrays,
                         tuple(t._version for t in arrays))


def check_layout(layout: NormalsLayout, query_points: torch.Tensor, points: torch.Tensor,
                 mask: torch.Tensor):
    """Raise unless ``layout`` was made by ``normals_layout`` with these very
    tensors, unchanged since."""
    arrays = (query_points, points, mask)
    if (len(layout.arrays) != 3 or any(a is not b for a, b in zip(layout.arrays, arrays))
            or tuple(t._version for t in arrays) != layout.versions):
        raise ValueError("normals layout was not made with this call's query points, "
                         "support and mask, or they changed since: make it with "
                         "normals_layout")


def _cuda_layout(name: str, query_points, points, mask, layout) -> NormalsLayout:
    """The call's layout on a CUDA device (made when not given), or raise."""
    dev = points.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in (query_points, points, mask):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous on {dev}")
    if query_points.dtype != torch.float32 or points.dtype != torch.float32:
        raise ValueError(f"{name}: points must be float32")
    if layout is None:
        layout = normals_layout(query_points, points, mask)
    check_layout(layout, query_points, points, mask)
    return layout


def _per_query_r2(radius, m: int, dev: torch.device) -> torch.Tensor:
    if not torch.is_tensor(radius):
        radius = torch.full((), float(radius), dtype=torch.float32, device=dev)
    return (radius.to(torch.float32) ** 2).expand(m).contiguous()


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row of (N, 3), summed x, then y, then z (the kernel's order)."""
    return (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]


# --- the k-th-neighbour prepass ---------------------------------------------

def kth_neighbor_d2_within_plain(query_points: torch.Tensor, points: torch.Tensor,
                                 mask: torch.Tensor, k: int, cap: float) -> torch.Tensor:
    """Plain PyTorch version of the prepass kernel: queries (M, 3), support
    (N, 3) and validity (N,) as given, 1 <= k <= N, cap = r^2 as a float32
    value -> (M,) k-th smallest of (|q|^2 + |t|^2) - 2 q.t over the valid
    support, clamped to [0, cap].  The dot is a float32 matrix product (an
    FMA chain over x, y, z, which the kernel repeats); chunked over
    queries."""
    n = points.shape[0]
    t2 = torch.where(mask, _sq_norms(points), torch.full_like(points[:, 0], float("inf")))
    q2 = _sq_norms(query_points)
    pt = points.t().contiguous()
    chunk = max(1, _PLAIN_PAIRS // max(n, 1))
    out = []
    for s in range(0, query_points.shape[0], chunk):
        d2 = q2[s:s + chunk, None] + t2[None, :] - 2.0 * (query_points[s:s + chunk] @ pt)
        out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True).values[:, k - 1])
    return torch.clamp(torch.cat(out), min=0.0, max=cap)


def plan_splits(m: int, n_tiles: int, device: torch.device, max_splits: int) -> int:
    """Splits of the support tiles per query group for a K2 launch: about
    ``_WARPS_PER_SM`` sweep warps per SM, at most ``max_splits`` (each split
    writes its partial result, which a second kernel merges) and one per
    tile.  A query group whose box meets many tiles then spreads them over
    several warps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = max(1, -(-m // nn_layout.GROUP))
    return max(1, min(-(-_WARPS_PER_SM * sms // groups), max_splits, n_tiles))


def _launch_kth(query_points: torch.Tensor, layout: NormalsLayout, k: int,
                cap: float) -> torch.Tensor:
    lib = cuda_build.load("normals")
    fn = lib.kth_within_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] +
                   [ctypes.c_int] + [ctypes.c_void_p] * 3)
    if ((lib.normals_tile_size(), lib.normals_group_size(), lib.kth_max_k())
            != (nn_layout.TILE, nn_layout.GROUP, KTH_MAX_K)):
        raise RuntimeError("csrc/normals.cu and ops/cuda_normals.py disagree on the "
                           "tile or group size or the largest k")
    dev = query_points.device
    m = query_points.shape[0]
    t = layout.target
    n_tiles = t.boxes.shape[0]
    splits = plan_splits(m, n_tiles, dev, _KTH_MAX_SPLITS)
    part = torch.empty((splits, m, k) if splits > 1 else (1,), dtype=torch.float32,
                       device=dev)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    err = fn(query_points.data_ptr(), layout.query_order.data_ptr(), t.pts.data_ptr(),
             t.boxes.data_ptr(), n_tiles, m, k, cap, splits, part.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "kth_neighbor_d2_within")
    return out


def kth_neighbor_d2_within(query_points: torch.Tensor, points: torch.Tensor,
                           mask: torch.Tensor, k: int, radius: float,
                           layout: Optional[NormalsLayout] = None) -> torch.Tensor:
    """(M,) min(r^2, d_k^2) of ``query_points`` (M, 3) against the support
    ``points`` (N, 3) / ``mask`` (N,), d_k^2 in the JAX package's expansion
    form (k above N takes the N-th, as the JAX function does; fewer than k
    valid points give r^2).  ``radius`` a finite float; ``layout`` the
    call's ``normals_layout``, made here when not given.  On CUDA a k above
    ``KTH_MAX_K`` raises."""
    k = min(int(k), points.shape[0])
    if k < 1:
        raise ValueError("kth_neighbor_d2_within: k and the support must be at least 1")
    cap = float(torch.tensor(float(radius), dtype=torch.float32) ** 2)
    if points.device.type == "cpu":
        if layout is not None:
            check_layout(layout, query_points, points, mask)
        return kth_neighbor_d2_within_plain(query_points, points, mask, k, cap)
    layout = _cuda_layout("kth_neighbor_d2_within", query_points, points, mask, layout)
    if k > KTH_MAX_K:
        raise ValueError(f"kth_neighbor_d2_within: k = {k} is above the kernel's "
                         f"maximum {KTH_MAX_K}")
    cuda_build.count_launch("kth_neighbor_d2_within",
                            (query_points.shape[0], points.shape[0]))
    return _launch_kth(query_points, layout, k, cap)


# --- the moments --------------------------------------------------------------

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


def _launch_moments(query_points: torch.Tensor, layout: NormalsLayout,
                    r2: torch.Tensor) -> torch.Tensor:
    lib = cuda_build.load("normals")
    fn = lib.moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    dev = query_points.device
    m = query_points.shape[0]
    t = layout.target
    n_tiles = t.boxes.shape[0]
    splits = plan_splits(m, n_tiles, dev, _MOMENTS_MAX_SPLITS)
    part = torch.empty((splits, m, 10) if splits > 1 else (1,), dtype=torch.float32,
                       device=dev)
    out = torch.empty((m, 16), dtype=torch.float32, device=dev)
    err = fn(query_points.data_ptr(), layout.query_order.data_ptr(), r2.data_ptr(),
             layout.centroid.data_ptr(), t.pts.data_ptr(), t.boxes.data_ptr(),
             n_tiles, m, splits, part.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "radius_moments")
    return out


def moment_inputs(query_points: torch.Tensor, points: torch.Tensor,
                  mask: torch.Tensor, radius):
    """What the plain version reads, as the JAX package builds it around its
    Pallas call: queries and support centred on the support centroid, the
    support validity as float, the 16 support features [1, x, y, z, xx, xy,
    xz, yy, yz, zz, 0...] and the per-query r^2.  Returns (q, p, maskf,
    feats, r2)."""
    m, n = query_points.shape[0], points.shape[0]
    dev = points.device
    centroid, maskf = support_centroid(points, mask)
    p = (points - centroid).contiguous()
    q = (query_points - centroid).contiguous()
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    feats = torch.cat([torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                                    x * z, y * y, y * z, z * z], dim=1),
                       torch.zeros((n, 6), dtype=torch.float32, device=dev)],
                      dim=1).contiguous()
    return q, p, maskf, feats, _per_query_r2(radius, m, dev)


def radius_moments_at(query_points: torch.Tensor, points: torch.Tensor,
                      mask: torch.Tensor, radius,
                      layout: Optional[NormalsLayout] = None) -> torch.Tensor:
    """Radius-neighbourhood moments of ``query_points`` (M, 3) against a
    support cloud ``points`` (N, 3) / ``mask`` (N,); ``radius`` finite,
    scalar or per-query (M,); ``layout`` the call's ``normals_layout``, made
    here when not given.  Returns (M, 16): col 0 = neighbour count, cols 1:4
    = sums of positions, cols 4:10 = sums of (xx, xy, xz, yy, yz, zz), all
    in support-centroid-centred coordinates."""
    if points.device.type == "cpu":
        if layout is not None:
            check_layout(layout, query_points, points, mask)
        return radius_moments_plain(*moment_inputs(query_points, points, mask, radius))
    layout = _cuda_layout("radius_moments_at", query_points, points, mask, layout)
    r2 = _per_query_r2(radius, query_points.shape[0], points.device)
    cuda_build.count_launch("radius_moments_at",
                            (query_points.shape[0], points.shape[0]))
    return _launch_moments(query_points, layout, r2)


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


# --- the JAX package's prepass (expansion form, uncapped) -------------------

def kth_neighbor_d2_at(query_points: torch.Tensor, points: torch.Tensor,
                       mask: torch.Tensor, k: int, chunk: int = 2048) -> torch.Tensor:
    """Per-query squared distance to the k-th nearest valid SUPPORT point
    (the query counts when it is in the support), expansion form, exact:
    the JAX function with ``exact=True``."""
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
    """Per-point hybrid radius min(r, d_k), inflated by (1 + 1e-5): the JAX
    package's d_k comes from the expansion form while its moments kernel
    tests the difference form, and the two disagree in the last ulps; the
    inflation keeps the k-th neighbour inside (the port's prepass takes the
    moments' own form, and keeps the inflation so that its radii are the
    JAX package's)."""
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
