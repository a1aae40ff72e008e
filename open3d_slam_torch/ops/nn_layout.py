"""The layout that the nearest-neighbour sweep of kernels K1 and K4 reads,
and the two normals kernels of K2 (``ops/cuda_normals.normals_layout``).

The sweep (``csrc/nn_sweep.cuh``) takes queries in groups of ``GROUP`` and
targets in tiles of ``TILE``, and skips every (group, tile) pair whose boxes
lie farther apart than the correspondence distance.  The skip is exact, but
how much it leaves depends on how compact the groups and tiles are.  This
module orders both sides along a Morton curve, in plain PyTorch:

- ``target_layout``: once per target, the valid targets in Morton order,
  invalid ones last, each staged as one float4 (x, y, z, grid index as
  int32 bits) with invalid and padding rows at ``SENTINEL`` (their squared
  distance overflows to +inf), a box per tile of the valid points in it,
  and the order itself (a cloud that was a target and becomes a source,
  as odometry's does one scan later, needs no other query order);
- ``query_order``: once per registration call, the Morton order of the
  untransformed source.  A rigid transform keeps a compact group compact,
  so the order holds for every Gauss-Newton iteration.

The Morton code is that of a point's ``CELL`` cell counted from the valid
points' minimum corner, modulo 1024 per axis: the curve wraps 256 m from
that corner, where a tile that straddles the seam only gets a larger box.
Cells counted from the origin would put a seam through a ground plane at
z = 0 and split it into two layers of half the density, whose tiles have
boxes twice the area.

A target layout is a second copy of the target coordinates and validity,
which the sweep reads in place of the kernel's own target arrays.  So it is
made only with those arrays (``prepare_target`` of each kernel, or
``layout_for``) and keeps them (``bind``): a wrapper refuses a layout that
was made for other arrays, or whose arrays changed in place since.

``SweepLayout`` bundles both for the kernel wrappers' ``layout`` argument.
``tile_need`` is the sweep's skip test at the kernel's granularity (how
many pairs a call sweeps), and ``plan_splits`` how many splits of the target
tiles a launch uses.  ``scratch`` keeps, per device and stream, the two
buffers the kernels leave as they found them: one 64-bit key per query
(all ones) that the splits' atomicMin merges into, and one integer ticket
per batch element (zero) with which the last block of a row kernel finds
itself.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

TILE = 64          # targets per tile (nn::kTile)
GROUP = 64         # queries per group: 32 lanes x 2 (nn::kGroup)
SENTINEL = 3.0e38  # staged coordinate of an invalid or padding target
CELL = 0.25        # Morton cell edge, metres
_BIG = 3.0e38
_BITS = 10         # Morton bits per axis
_WARPS_PER_SM = 128  # sweep warps a launch aims for per SM (several waves)

_spread: Dict[torch.device, torch.Tensor] = {}
_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


class TargetLayout(NamedTuple):
    pts: torch.Tensor     # (..., n_tiles * TILE, 4) float32
    boxes: torch.Tensor   # (..., n_tiles, 8) float32: [min xyz, max xyz, 0, 0]
    order: torch.Tensor   # (..., N) int32: the Morton order of the targets
    # The kernel's target coordinates and validity the layout was made with
    # (``bind``), and their version counters then.
    arrays: Tuple[torch.Tensor, ...] = ()
    versions: Tuple[int, ...] = ()


class SweepLayout(NamedTuple):
    target: TargetLayout
    query_order: torch.Tensor   # (M,) or (B, M) int32


def _spread_table(device: torch.device) -> torch.Tensor:
    """(2^_BITS, 3) int32: column a holds v's bits spread three apart and
    shifted so that x, y and z interleave as z y x ... z y x."""
    t = _spread.get(device)
    if t is None:
        v = torch.arange(1 << _BITS, dtype=torch.int64)
        s = torch.zeros_like(v)
        for bit in range(_BITS):
            s |= ((v >> bit) & 1) << (3 * bit)
        t = torch.stack([s << 2, s << 1, s], dim=1).to(torch.int32).to(device)
        _spread[device] = t
    return t


def morton_order(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., N) int64: the valid rows of ``points`` (..., N, 3) in Morton
    order of their ``CELL`` cell counted from the valid points' minimum
    corner (modulo 2^10 per axis), then the invalid rows (a stable sort:
    points of one cell keep their index order)."""
    lo = torch.where(valid[..., None], points, _BIG).amin(dim=-2, keepdim=True)
    cell = torch.floor((points - lo) * (1.0 / CELL)).to(torch.int64) & ((1 << _BITS) - 1)
    table = _spread_table(points.device)
    code = torch.gather(table, 0, cell.reshape(-1, 3)).sum(-1).reshape(valid.shape)
    code = torch.where(valid, code, torch.iinfo(torch.int64).max)
    return torch.argsort(code, dim=-1, stable=True)


def query_order(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., M) int32 Morton order of the source points (..., M, 3)."""
    return morton_order(points, valid).to(torch.int32).contiguous()


def target_layout(points: torch.Tensor, valid: torch.Tensor) -> TargetLayout:
    """The staged targets, tile boxes and Morton order of points (..., N, 3)
    with validity (..., N), padded to whole tiles."""
    n = points.shape[-2]
    n_pad = max(1, -(-n // TILE)) * TILE
    perm = morton_order(points, valid)
    order = perm.to(torch.int32)
    p = torch.gather(points, -2, perm[..., None].expand(*perm.shape, 3))
    v = torch.gather(valid, -1, perm)
    staged = order
    if n_pad > n:
        lead = order.shape[:-1]
        p = torch.cat([p, p.new_zeros(*lead, n_pad - n, 3)], dim=-2)
        v = torch.cat([v, v.new_zeros(*lead, n_pad - n)], dim=-1)
        staged = torch.cat([order, order.new_zeros(*lead, n_pad - n)], dim=-1)
    xyz = torch.where(v[..., None], p, SENTINEL)
    idx = staged.view(torch.float32)[..., None]
    tiles = xyz.reshape(*xyz.shape[:-2], n_pad // TILE, TILE, 3)
    vt = v.reshape(*v.shape[:-1], n_pad // TILE, TILE, 1)
    mins = tiles.amin(dim=-2)
    maxs = torch.where(vt, tiles, -_BIG).amax(dim=-2)
    boxes = torch.cat([mins, maxs, torch.zeros_like(mins[..., :2])], dim=-1)
    return TargetLayout(pts=torch.cat([xyz, idx], dim=-1).contiguous(),
                        boxes=boxes.contiguous(), order=order)


def bind(layout: TargetLayout, coords: torch.Tensor, tv: torch.Tensor) -> TargetLayout:
    """``layout`` tied to the kernel's target arrays it was made with: the
    coordinates ``coords`` (t_t of K4, td of K1) and the validity ``tv``."""
    return layout._replace(arrays=(coords, tv), versions=(coords._version, tv._version))


def layout_for(q_pts: torch.Tensor, q_mask_f: torch.Tensor, coords: torch.Tensor,
               tv: torch.Tensor) -> SweepLayout:
    """A layout from a kernel call's own inputs (for callers that keep
    none): targets whose x, y, z are rows 0..2 of ``coords`` (..., R, N)
    (t_t of K4, td of K1), validity tv (..., 1, N); queries in the order of
    the points as given, one order per batch element."""
    b, m, _ = q_pts.shape
    qv = (q_mask_f.reshape(-1, m) > 0.0).expand(b, m)
    target = target_layout(coords[..., 0:3, :].transpose(-1, -2), tv[..., 0, :] > 0.0)
    return SweepLayout(bind(target, coords, tv), query_order(q_pts, qv))


def check_layout(layout: SweepLayout, b: int, m: int, n: int, device: torch.device,
                 coords: torch.Tensor, tv: torch.Tensor):
    """Raise unless ``layout`` fits a call with B = b, M = m, N = n on
    ``device`` whose target coordinates and validity are ``coords`` and
    ``tv``: the target layout must have been made with these very tensors
    (``bind``), unchanged since.  The query order is read as it comes; the
    kernels mark a call whose order leaves out a valid query (NaN inlier
    count, ``csrc/nn_sweep.cuh``)."""
    lead = (b,) if coords.dim() == 3 else ()
    n_tiles = max(1, -(-n // TILE))
    target = layout.target
    pts, boxes = target.pts, target.boxes
    order = layout.query_order
    if (tuple(pts.shape) != lead + (n_tiles * TILE, 4)
            or tuple(boxes.shape) != lead + (n_tiles, 8)
            or tuple(order.shape) not in ((m,), (b, m))
            or order.dtype != torch.int32 or pts.dtype != torch.float32
            or boxes.dtype != torch.float32
            or any(t.device != device or not t.is_contiguous()
                   for t in (pts, boxes, order))):
        raise ValueError("layout does not fit the call: expected target pts "
                         f"{lead + (n_tiles * TILE, 4)}, boxes {lead + (n_tiles, 8)}, "
                         f"query order ({m},) or ({b}, {m}) int32, contiguous on {device}")
    if (len(target.arrays) != 2 or target.arrays[0] is not coords
            or target.arrays[1] is not tv
            or (coords._version, tv._version) != target.versions):
        raise ValueError("layout was not made with this call's target arrays, or they "
                         "changed since: use the layout that prepare_target returned "
                         "with them")


def tile_need(q_pts: torch.Tensor, q_mask_f: torch.Tensor, layout: SweepLayout,
              r2: torch.Tensor) -> torch.Tensor:
    """(B, groups, tiles) bool: the (query group, target tile) pairs the
    sweep does not skip, with the kernel's groups, boxes and rounding.
    ``r2`` is one squared distance (1, 1), or one per query (M,) or (B, M):
    then a group's threshold is the largest r2 of its valid queries, as the
    normals kernels (``csrc/normals.cu``) take it."""
    b, m, _ = q_pts.shape
    order = layout.query_order.long().expand(b, m)
    n_groups = -(-m // GROUP)
    pad = n_groups * GROUP - m
    q = torch.gather(q_pts, 1, order[..., None].expand(b, m, 3))
    qv = torch.gather((q_mask_f.reshape(-1, m) > 0.0).expand(b, m), 1, order)
    per_query = r2.numel() > 1
    if per_query:
        thr = torch.where(qv, torch.gather(r2.reshape(-1, m).expand(b, m), 1, order), -_BIG)
    if pad:
        q = torch.cat([q, q.new_zeros(b, pad, 3)], dim=1)
        qv = torch.cat([qv, qv.new_zeros(b, pad)], dim=1)
        if per_query:
            thr = torch.cat([thr, thr.new_full((b, pad), -_BIG)], dim=1)
    thr = (thr.reshape(b, n_groups, GROUP).amax(dim=2)[..., None] if per_query
           else r2.reshape(()))
    q = q.reshape(b, n_groups, GROUP, 3)
    qv = qv.reshape(b, n_groups, GROUP, 1)
    lo = torch.where(qv, q, _BIG).amin(dim=2)[:, :, None]
    hi = torch.where(qv, q, -_BIG).amax(dim=2)[:, :, None]
    boxes = layout.target.boxes
    boxes = (boxes if boxes.dim() == 3 else boxes[None])[:, None]
    g = torch.clamp(torch.maximum(boxes[..., 0:3] - hi, lo - boxes[..., 3:6]), min=0.0)
    g2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    return g2 <= thr


def plan_splits(n_groups: int, b: int, n_tiles: int, device: torch.device) -> int:
    """Splits of the target tiles per query group: about ``_WARPS_PER_SM``
    sweep warps per SM, several waves, so that a group whose box meets many
    tiles spreads them over many warps; at most one split per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-_WARPS_PER_SM * sms // max(n_groups * b, 1))
    return max(1, min(want, n_tiles, 65535))


def scratch(device: torch.device, stream: int, b: int, m: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, tickets) for a call with B = b, M = m on ``stream``: at least
    b * m int64 keys of all ones and b int32 tickets of zero.  The kernels
    leave both so; a call that needs more gets new, filled buffers."""
    k = (device, stream)
    keys, tickets = _scratch.get(k, (None, None))
    if keys is None or keys.numel() < b * m:
        keys = torch.full((max(b * m, 1 << 16),), -1, dtype=torch.int64, device=device)
    if tickets is None or tickets.numel() < b:
        tickets = torch.zeros(max(b, 1024), dtype=torch.int32, device=device)
    _scratch[k] = (keys, tickets)
    return keys, tickets
