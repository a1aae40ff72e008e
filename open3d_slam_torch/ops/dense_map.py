"""Device-resident voxelized point cloud: the dense map store.

Port of ``open3d_slam_tpu.ops.dense_map`` (reference ``VoxelizedPointCloud``,
``Voxel.cpp:49-114``): a voxel map whose voxels aggregate the points,
normals and colours that fall in them (``AggregatedVoxel``,
``Voxel.cpp:27-36``) and give back their means.

The store has a fixed capacity and is sorted by key; ``INT32_MAX`` marks an
empty slot, and every empty slot holds zero sums.  Keys are collision-free
packed voxel coords relative to ``region_base``, which the first ``insert``
anchors at the scan's mean voxel (``_BASE_UNSET`` until then); points
outside the 1290^3-voxel region are dropped.  Positions are summed as
residuals from their voxel's centre, and a mean is rebuilt, as the JAX
package rebuilds it, as centre + resid_sum / max(count, 1) in float32.

The JAX package sums with one multi-operand ``lax.sort`` and a float32
running sum over the whole merged store, so a sum there carries the running
sum's rounding (up to ~2e-2 on colour sums of a 260k-voxel store).  Here
the sums stay in int64 fixed point (2^-32 units, as ``voxel.
merge_clouds_by_voxel`` sums) between inserts: an insert sorts the keys of
store and scan with one stable ``torch.sort``, gathers the channels, and
takes each segment's sum as the difference of an exact int64 running sum
along the rows of the (channels, rows) layout.  So the sums are exact, the
same in every order, and rounded only where a mean is read; there are no
float atomics.

Bytes per voxel: 4 (the int32 key) + 10 x 8 (the int64 sums of the residual,
normal and colour, 3 each, and the count) = 84; 44,040,192 bytes for a
524288-voxel submap.  Nothing here pulls a value to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from open3d_slam_torch.ops.voxel import (EXACT_EXTENT, INT32_MAX, _FIXED_SCALE,
                                         pack_coords, region_base_from_center,
                                         voxel_coords)
from open3d_slam_torch.utils.pointcloud import PointCloud

_BASE_UNSET = -2 ** 31      # region base not yet anchored
N_CHANNELS = 10             # residual xyz, normal xyz, colour rgb, count
BYTES_PER_VOXEL = 4 + 8 * N_CHANNELS


@dataclasses.dataclass(frozen=True)
class VoxelizedPointCloud:
    """Fixed-capacity voxel aggregate store, keys ascending.

    Attributes:
      keys:        (C,) int32, sorted; ``INT32_MAX`` = empty slot.
      sums:        (10, C) int64 fixed point at ``_FIXED_SCALE``: rows 0-2
                   the voxel-centre-relative residuals, 3-5 the normals, 6-8
                   the colours, 9 the count.  Zero at empty slots.
      voxel_size:  Python float (never a device scalar: reading it costs no
                   sync).
      region_base: (3,) int32 voxel coord; ``_BASE_UNSET`` until anchored.
    """

    keys: torch.Tensor
    sums: torch.Tensor
    voxel_size: float
    region_base: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def num_voxels(self) -> torch.Tensor:
        return (self.keys != INT32_MAX).sum(dtype=torch.int32)

    def _channel(self, lo: int, hi: int) -> torch.Tensor:
        """float32 (C, hi - lo) of the sums' rows lo:hi."""
        return (self.sums[lo:hi].t().to(torch.float64) / _FIXED_SCALE).to(torch.float32)

    @property
    def resid_sum(self) -> torch.Tensor:
        return self._channel(0, 3)

    @property
    def normal_sum(self) -> torch.Tensor:
        return self._channel(3, 6)

    @property
    def color_sum(self) -> torch.Tensor:
        return self._channel(6, 9)

    @property
    def count(self) -> torch.Tensor:
        return self._channel(9, 10)[:, 0]

    def _means(self) -> torch.Tensor:
        """Absolute per-voxel means (garbage at empty slots)."""
        e = EXACT_EXTENT
        k = torch.clamp(self.keys, min=0)
        coords = torch.stack([k // (e * e), (k // e) % e, k % e], dim=-1) + self.region_base
        centers = (coords.to(torch.float32) + 0.5) * self.voxel_size
        return centers + self.resid_sum / torch.clamp(self.count, min=1.0)[:, None]


def empty(capacity: int, voxel_size: float, device="cuda") -> VoxelizedPointCloud:
    return VoxelizedPointCloud(
        keys=torch.full((capacity,), INT32_MAX, dtype=torch.int32, device=device),
        sums=torch.zeros((N_CHANNELS, capacity), dtype=torch.int64, device=device),
        voxel_size=float(voxel_size),
        region_base=torch.full((3,), _BASE_UNSET, dtype=torch.int32, device=device))


def _fixed(vals: torch.Tensor) -> torch.Tensor:
    """(n, k) float32 -> (k, n) int64 fixed point (exact below 2^31)."""
    return torch.round(vals.to(torch.float64) * _FIXED_SCALE).to(torch.int64).t()


def _mean_voxel_base(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Region base centred on the valid coords' mean, as the JAX package
    takes it (float32 sum / max(count, 1), truncated); the sum is exact here
    (int64), equal to the JAX package's wherever its float32 sum is."""
    n = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    total = torch.where(valid[:, None], coords.to(torch.int64),
                        torch.zeros((), dtype=torch.int64, device=coords.device)).sum(dim=0)
    return region_base_from_center((total.to(torch.float32) / n).to(torch.int32))


def _sorted_store(keys: torch.Tensor, sums: torch.Tensor, voxel_size: float,
                  region_base: torch.Tensor) -> VoxelizedPointCloud:
    """The store of ``keys``/``sums`` reordered by a stable sort of the keys;
    rows keyed ``INT32_MAX`` must hold zero sums."""
    ks, perm = torch.sort(keys, stable=True)
    return VoxelizedPointCloud(keys=ks, sums=sums[:, perm], voxel_size=voxel_size,
                               region_base=region_base)


def insert(vm: VoxelizedPointCloud, pc: PointCloud) -> VoxelizedPointCloud:
    """Aggregate a cloud into the store (``VoxelizedPointCloud::insert``,
    ``Voxel.cpp:66-88``).  More voxels than the capacity drop the largest
    keys, as in the JAX package; callers size the capacity to avoid it."""
    dev = vm.keys.device
    vs = vm.voxel_size
    coords = voxel_coords(pc.points, vs)
    base = torch.where(vm.region_base[0] == _BASE_UNSET,
                       _mean_voxel_base(coords, pc.mask), vm.region_base)
    packed = pack_coords(coords, base)
    keys_new = torch.where(pc.mask & (packed >= 0), packed,
                           torch.full_like(packed, INT32_MAX))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    resid = pc.points - (coords.to(torch.float32) + 0.5) * vs
    chans = [resid,
             pc.normals if pc.normals is not None else torch.zeros_like(resid),
             pc.colors if pc.colors is not None else torch.zeros_like(resid),
             torch.ones_like(resid[:, :1])]
    vals = torch.where((keys_new != INT32_MAX)[:, None], torch.cat(chans, dim=1), zero)

    keys = torch.cat([vm.keys, keys_new])
    ks, perm = torch.sort(keys, stable=True)
    rows = torch.cat([vm.sums, _fixed(vals)], dim=1)[:, perm]
    n, C = ks.shape[0], vm.capacity
    # Running sums along the rows of the (channels, n + 1) layout: a scan down
    # the leading axis of a tall tensor is one sequential thread per channel
    # on the GPU.  int64 sums are exact and wrap-safe under the difference.
    csum = torch.cumsum(torch.cat([torch.zeros((N_CHANNELS, 1), dtype=torch.int64,
                                               device=dev), rows], dim=1), dim=1)
    vs_row = ks != INT32_MAX
    starts = (ks != torch.roll(ks, 1)) & vs_row
    starts[0] = vs_row[0]
    # Segment s spans [bounded[s], bounded[s+1]); entries past the last
    # segment equal n, so the store's empty tail sums to zero.
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    bounded = torch.sort(torch.where(starts, iota, torch.full_like(iota, n))).values
    bounded_ext = torch.cat([bounded, torch.full((1,), n, dtype=torch.int32, device=dev)])
    edges = bounded_ext[torch.clamp(torch.arange(C + 1, device=dev), max=n)].long()
    g = csum[:, edges]
    ks_pad = torch.cat([ks, torch.full((1,), INT32_MAX, dtype=torch.int32, device=dev)])
    return VoxelizedPointCloud(keys=ks_pad[edges[:C]], sums=g[:, 1:] - g[:, :-1],
                               voxel_size=vs, region_base=base)


def remove_keys(vm: VoxelizedPointCloud, keys_to_remove_sorted: torch.Tensor,
                region_base: torch.Tensor,
                neighbor_deltas: Optional[torch.Tensor] = None) -> VoxelizedPointCloud:
    """Flush the voxels whose exact key relative to ``region_base`` (re-keyed
    from the voxel's mean, which lies in its voxel) is in the sorted removal
    set (carving, ``helpers.cpp:347-377``).  With ``neighbor_deltas``
    (``carving.face_neighbor_deltas``) a voxel also goes when any of its
    delta-shifted keys is in the set."""
    valid = vm.keys != INT32_MAX
    exact = pack_coords(voxel_coords(vm._means(), vm.voxel_size), region_base)
    exact = torch.where(valid, exact, torch.full_like(exact, -1))
    probe = exact[:, None].to(torch.int64)
    if neighbor_deltas is not None:
        probe = probe + neighbor_deltas[None, :].to(torch.int64)
    # A probe outside [0, E^3) matches no voxel of the removal set (whose
    # other keys are INT32_MAX); the JAX package's int32 probe wraps there.
    probe_ok = (exact[:, None] >= 0) & (probe >= 0) & (probe < EXACT_EXTENT ** 3)
    probe = torch.where(probe_ok, probe, torch.full_like(probe, -1)).to(torch.int32)
    pos = torch.clamp(torch.searchsorted(keys_to_remove_sorted, probe, side="left"),
                      0, keys_to_remove_sorted.shape[0] - 1)
    hit = ((keys_to_remove_sorted[pos] == probe) & probe_ok).any(dim=-1) & valid
    keys = torch.where(hit, torch.full_like(vm.keys, INT32_MAX), vm.keys)
    sums = torch.where(hit[None, :], torch.zeros((), dtype=torch.int64,
                                                 device=vm.sums.device), vm.sums)
    return _sorted_store(keys, sums, vm.voxel_size, vm.region_base)


def transform(vm: VoxelizedPointCloud, T: torch.Tensor) -> VoxelizedPointCloud:
    """Rigidly move the aggregate means (``VoxelizedPointCloud::transform``,
    ``Voxel.cpp:49-64``).  Each voxel is re-keyed from its moved mean, and
    the region base re-anchored at the moved voxels' mean, so a chain of
    loop-closure corrections cannot walk the map out of its region.  The
    residual and normal sums are rebuilt from the moved means (rounded
    there, as in the JAX package); colours and counts move exactly."""
    valid = vm.keys != INT32_MAX
    count = vm.count
    mean_t = vm._means() @ T[:3, :3].t() + T[:3, 3]
    nrm_t = (vm.normal_sum / torch.clamp(count, min=1.0)[:, None]) @ T[:3, :3].t()
    coords = voxel_coords(mean_t, vm.voxel_size)
    base = torch.where(vm.region_base[0] == _BASE_UNSET, vm.region_base,
                       _mean_voxel_base(coords, valid))
    packed = pack_coords(coords, base)
    keep = valid & (packed >= 0)
    keys = torch.where(keep, packed, torch.full_like(packed, INT32_MAX))
    resid_t = (mean_t - (coords.to(torch.float32) + 0.5) * vm.voxel_size) * count[:, None]
    moved = torch.cat([_fixed(resid_t), _fixed(nrm_t * count[:, None]), vm.sums[6:]], dim=0)
    # A voxel moved out of the region is dropped (the JAX package keeps its
    # sums behind an INT32_MAX key until the next insert discards them).
    sums = torch.where(keep[None, :], moved,
                       torch.zeros((), dtype=torch.int64, device=vm.sums.device))
    return _sorted_store(keys, sums, vm.voxel_size, base)


def to_point_cloud(vm: VoxelizedPointCloud) -> PointCloud:
    """Aggregate means as a padded PointCloud (``toPointCloud``,
    ``Voxel.cpp:90-114``): normals normalised (zero where they cancel),
    colours averaged."""
    valid = vm.keys != INT32_MAX
    zero = torch.zeros((), dtype=torch.float32, device=vm.keys.device)
    cnt = torch.clamp(vm.count, min=1.0)[:, None]
    nrm = vm.normal_sum / cnt
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = torch.where(nlen > 1e-9, nrm / torch.clamp(nlen, min=1e-9), zero)
    return PointCloud(points=torch.where(valid[:, None], vm._means(), zero), mask=valid,
                      normals=nrm, colors=vm.color_sum / cnt)
