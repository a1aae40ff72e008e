"""Voxel ops: packed voxel keys, the voxel merge engine, downsampling,
within-volume voxelization and duplicate removal.

Port of ``open3d_slam_tpu.ops.voxel``.  Semantics are the JAX package's:

  * keys are collision-free int32 packings of floor(p / voxel) relative to a
    region base (``EXACT_EXTENT``^3 < 2^31); ``OUT_OF_REGION`` rows are
    valid but unmergeable singletons; ``INT32_MAX`` marks empty rows;
  * ``merge_clouds_by_voxel`` returns the per-voxel means in PACKED-KEY order
    (spatially coherent — the GICP kernel's tile skip and the compaction rely
    on it), keeping a uniform stride of segments when there are more than the
    output capacity.

The JAX package's multi-operand ``lax.sort`` becomes one stable ``torch.sort``
of the int32 keys plus a gather of the value channels.  Segment sums are the
difference of a running sum, as there; the running sum is taken in int64
fixed point (2^-32 units) instead of float32, because a float scan on the GPU
associates its partial sums in a timing-dependent order and the replay must
be reproducible bit for bit.  Integer sums are exact and wrap-safe under the
difference, so the segment sums are also more accurate than a float32 scan.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from open3d_slam_torch.utils.pointcloud import PointCloud

INT32_MAX = 2 ** 31 - 1
EXACT_EXTENT = 1290
OUT_OF_REGION = INT32_MAX - 1
_FIXED_SCALE = 2.0 ** 32


def voxel_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Integer voxel coordinates, floor(p / voxel_size) (int32)."""
    return torch.floor(points / voxel_size).to(torch.int32)


def hash_coords(coords: torch.Tensor) -> torch.Tensor:
    """Additive large-prime spatial hash of int32 voxel coords -> int32, with
    the JAX package's wrapping int32 arithmetic: computed in int64 and wrapped
    to 32 bits, so the hashes (and a sort by them) are bit-equal to JAX's."""
    c = coords.to(torch.int64)
    h = c[..., 0] * 73856093 + c[..., 1] * 19349669 + c[..., 2] * 83492791
    return (((h + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31).to(torch.int32)


def pack_coords(coords: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Exact int32 key of voxel ``coords`` relative to ``base`` (3,);
    out-of-region -> -1.  Linear: +-x -> +-E^2, +-y -> +-E, +-z -> +-1."""
    rel = coords - base
    in_range = torch.all((rel >= 0) & (rel < EXACT_EXTENT), dim=-1)
    packed = (rel[..., 0] * EXACT_EXTENT + rel[..., 1]) * EXACT_EXTENT + rel[..., 2]
    return torch.where(in_range, packed, torch.full_like(packed, -1))


def unpack_key_centers(keys: torch.Tensor, voxel_size: float,
                       base: torch.Tensor) -> torch.Tensor:
    """Voxel centres decoded from packed keys (caller masks keys >=
    OUT_OF_REGION)."""
    e = EXACT_EXTENT
    coords = torch.stack([keys // (e * e), (keys // e) % e, keys % e], dim=-1) + base
    return (coords.to(torch.float32) + 0.5) * voxel_size


def region_base_from_center(center_coord: torch.Tensor) -> torch.Tensor:
    """Region base such that ``center_coord`` sits at the region centre."""
    return center_coord - EXACT_EXTENT // 2


def span_keys(points: torch.Tensor, valid: torch.Tensor, voxel_size: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed keys with the region anchored at the cloud's min valid coord;
    out-of-region points become OUT_OF_REGION singletons."""
    coords = voxel_coords(points, voxel_size)
    big = torch.full_like(coords, INT32_MAX)
    base = torch.min(torch.where(valid[:, None], coords, big), dim=0).values
    packed = pack_coords(coords, base)
    keys = torch.where(packed >= 0, packed, torch.full_like(packed, OUT_OF_REGION))
    return torch.where(valid, keys, torch.full_like(keys, INT32_MAX)), base


def _norm_safe(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def merge_clouds_by_voxel(keys: torch.Tensor, points: torch.Tensor,
                          normals: Optional[torch.Tensor],
                          colors: Optional[torch.Tensor],
                          voxel_size: float, base: torch.Tensor,
                          out_capacity: int,
                          exact_passthrough: bool = False) -> PointCloud:
    """Per-voxel mean of rows sharing a key -> key-sorted padded cloud.

    Rows with key INT32_MAX are ignored; OUT_OF_REGION rows stay singleton
    segments.  Positions are summed as voxel-local residuals and rebuilt as
    decoded voxel centre + mean residual.  ``exact_passthrough`` carries the
    absolute position of singleton pass-through rows through the sort."""
    n = keys.shape[0]
    dev = keys.device
    valid = keys != INT32_MAX
    in_region = keys < OUT_OF_REGION
    zero3 = torch.zeros((), dtype=torch.float32, device=dev)
    centers = torch.where(in_region[:, None],
                          unpack_key_centers(torch.clamp(keys, min=0),
                                             voxel_size, base), zero3)
    chans = [points - centers, valid.to(torch.float32)[:, None]]
    if normals is not None:
        chans.append(normals)
    if colors is not None:
        chans.append(colors)
    vals = torch.where(valid[:, None], torch.cat(chans, dim=1), zero3)

    ks, perm = torch.sort(keys, stable=True)
    fixed = torch.round(vals[perm].to(torch.float64) * _FIXED_SCALE).to(torch.int64)
    # Running sums along the rows of the (channels, n + 1) transpose: on the
    # GPU a scan down the leading axis of a tall, narrow tensor is one
    # sequential thread per channel, a scan along the last axis is parallel.
    csum = torch.cumsum(torch.cat([torch.zeros((vals.shape[1], 1), dtype=torch.int64,
                                               device=dev), fixed.t()], dim=1), dim=1)
    vs_row = ks != INT32_MAX
    starts = ((ks != torch.roll(ks, 1)) | (ks == OUT_OF_REGION)) & vs_row
    starts[0] = vs_row[0]

    # Segment s spans [bounded[s], bounded[s+1]); entries past the last
    # segment equal n, whose running sum covers every valid row.
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    bounded = torch.sort(torch.where(starts, iota, torch.full_like(iota, n))).values
    bounded_ext = torch.cat([bounded, torch.full((1,), n, dtype=torch.int32, device=dev)])
    ks_pad = torch.cat([ks, torch.full((1,), INT32_MAX, dtype=torch.int32, device=dev)])
    n_segments = starts.sum(dtype=torch.int32)

    C = out_capacity
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    stride = n_segments.to(torch.float32) / float(C)
    strided = torch.floor(ar.to(torch.float32) * stride).to(torch.int32)
    sidx = torch.where(n_segments > C, strided, ar).long()
    s = bounded_ext[torch.clamp(sidx, max=n)].long()
    e = bounded_ext[torch.clamp(sidx + 1, max=n)].long()
    # Contiguous (rows, channels), as a running sum down the rows would give:
    # a reduction over a strided last axis (the normals' norm below) may add
    # in another order on the GPU and round differently.
    d = ((csum[:, e] - csum[:, s]).t().contiguous().to(torch.float64)
         / _FIXED_SCALE).to(torch.float32)
    out_keys = ks_pad[s]

    count = d[:, 3]
    mask = count > 0.5
    denom = torch.clamp(count, min=1.0)[:, None]
    out_in_region = out_keys < OUT_OF_REGION
    out_centers = torch.where(
        out_in_region[:, None],
        unpack_key_centers(torch.clamp(out_keys, min=0), voxel_size, base), zero3)
    pts = out_centers + d[:, 0:3] / denom
    if exact_passthrough:
        abs_sorted = points[perm]
        ap = abs_sorted[torch.clamp(s, max=n - 1)]
        pts = torch.where(out_in_region[:, None], pts, ap)
    off = 4
    out_nrm = None
    if normals is not None:
        out_nrm = torch.where(mask[:, None], _norm_safe(d[:, off:off + 3]), zero3)
        off += 3
    out_col = None
    if colors is not None:
        out_col = d[:, off:off + 3] / denom
    return PointCloud(points=torch.where(mask[:, None], pts, zero3), mask=mask,
                      normals=out_nrm, colors=out_col)


def voxel_downsample(pc: PointCloud, voxel_size: float,
                     out_capacity: Optional[int] = None) -> PointCloud:
    """Voxel-grid downsample: mean position (and normal/colour) per voxel,
    valid points first in packed-key order (Open3D ``VoxelDownSample``)."""
    out_capacity = out_capacity or pc.capacity
    keys, base = span_keys(pc.points, pc.mask, voxel_size)
    return merge_clouds_by_voxel(keys, pc.points, pc.normals, pc.colors,
                                 voxel_size, base, out_capacity)


def random_downsample(pc: PointCloud, num_samples: int,
                      scores: torch.Tensor) -> PointCloud:
    """Keep the ``num_samples`` valid points with the smallest ``scores``
    (uniform draws, one per row, supplied by the caller's seeded generator —
    Open3D ``RandomDownSample``, ``Odometry.cpp:29``).  Mask-only."""
    n = pc.capacity
    s = torch.where(pc.mask, scores, torch.full_like(scores, float("inf")))
    order = torch.argsort(s, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return pc.with_(mask=pc.mask & (rank < num_samples))


def remove_duplicate_points_in_voxels(pc: PointCloud, voxel_size: float) -> PointCloud:
    """Keep only the first point (in scan order) per voxel, mask only
    (``VoxelMap::removeDuplicatePointsWithinSameVoxels``, ``Voxel.cpp:162-191``).
    A stable sort of the keys finds each voxel's first row; the keep flags go
    back to scan order through the sort's permutation."""
    keys, _ = span_keys(pc.points, pc.mask, voxel_size)
    ks, perm = torch.sort(keys, stable=True)
    vs_row = ks != INT32_MAX
    starts = ((ks != torch.roll(ks, 1)) | (ks == OUT_OF_REGION)) & vs_row
    starts[0] = vs_row[0]
    keep = torch.empty_like(starts)
    keep[perm] = starts
    return pc.with_(mask=pc.mask & keep)


def voxelize_within_cropping_volume(pc: PointCloud, voxel_size: float,
                                    inside: torch.Tensor,
                                    out_capacity: Optional[int] = None) -> PointCloud:
    """Voxel means of the points where ``inside`` holds; the other valid
    points pass through verbatim as singleton segments
    (``voxelizeWithinCroppingVolume``, ``helpers.cpp:115-183``).  A
    ``voxel_size`` <= 0 returns the input unchanged, as the reference does."""
    out_capacity = out_capacity or pc.capacity
    if voxel_size <= 0:
        return pc
    inside = inside & pc.mask
    keys, base = span_keys(pc.points, inside, voxel_size)
    keys = torch.where(pc.mask & ~inside, torch.full_like(keys, OUT_OF_REGION), keys)
    return merge_clouds_by_voxel(keys, pc.points, pc.normals, pc.colors,
                                 voxel_size, base, out_capacity,
                                 exact_passthrough=True)


def voxel_centers(coords: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Centre positions of voxels given their integer coords."""
    return (coords.to(torch.float32) + 0.5) * voxel_size
