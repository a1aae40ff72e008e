"""Port vs JAX: the dense map store (``ops/dense_map.py``), the dense-map
carve, duplicate removal, within-volume voxelization, ``compact``/``concat``,
``estimate_covariances``, ``Submap.insert_scan_dense_map``, the conversions
and the submap palette.

The store is held three ways:
- keys, counts and the region base exactly against JAX;
- positions (voxel means) against JAX within 1e-5 m;
- colour and normal sums against a float64 numpy sum of the same points
  within 1e-6 per entry, and against JAX no farther than JAX is from that
  float64 sum, plus 1e-6.  The JAX package takes its sums as differences of
  one float32 running sum over the whole merged store, so its own error
  grows with the store (ROADMAP §3); the port's sums are exact int64 fixed
  point (2^-32 units), so the only error is the inputs' quantization.

Means rebuilt in float32 (centre + resid_sum / count) can land just outside
their voxel; ``remove_keys`` and ``transform`` re-key from them.  The tests
count such boundary voxels and hold the re-keyed results equal elsewhere.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.io import conversions as jconv
from open3d_slam_tpu.models.submap import Submap as JaxSubmap
from open3d_slam_tpu.ops import carving as jcarv, dense_map as jdm, normals as jn
from open3d_slam_tpu.ops import voxel as jvox
from open3d_slam_tpu.utils import colors as jcolors, pointcloud as jpc
from open3d_slam_torch.io import conversions as tconv
from open3d_slam_torch.models.submap import Submap
from open3d_slam_torch.ops import carving as tcarv, dense_map as tdm, normals as tn
from open3d_slam_torch.ops import voxel as tvox
from open3d_slam_torch.utils import colors as tcolors, device as tdevice
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import jax_kernel_path, small_jax_params, to_torch_params

INT32_MAX = 2 ** 31 - 1
POS_TOL_M = 1e-5
SUM_TOL = 1e-6
VS = 0.05


def _pair(pts, mask=None, normals=None, colors=None):
    """The same cloud as a JAX and a port PointCloud."""
    mask = np.ones(len(pts), bool) if mask is None else mask

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    return (jpc.PointCloud(j(pts), j(mask), normals=j(normals), colors=j(colors)),
            tpc.PointCloud(t(pts), t(mask), normals=t(normals), colors=t(colors)))


def _scan(rng, n=4096, center=(3.0, -2.0, 1.0), extent=0.6, valid=0.9):
    pts = (rng.uniform(-extent, extent, (n, 3)) + np.float32(center)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, rng.uniform(size=n) < valid, nrm, col


def _f64_sums(scans, vs, base):
    """Per-voxel float64 sums of normals and colours, and the counts, of the
    valid in-region points of ``scans`` [(points, mask, normals, colors)],
    keyed as both packages key them: floor(p / vs) in float32, packed
    relative to ``base``.  Returns (sorted keys, normal sums, colour sums,
    counts)."""
    keys, nrm, col = [], [], []
    for pts, mask, n, c in scans:
        coords = np.floor(pts / np.float32(vs)).astype(np.int64)
        rel = coords - base.astype(np.int64)
        ok = mask & np.all((rel >= 0) & (rel < tvox.EXACT_EXTENT), axis=1)
        e = tvox.EXACT_EXTENT
        keys.append(((rel[:, 0] * e + rel[:, 1]) * e + rel[:, 2])[ok])
        nrm.append(n[ok].astype(np.float64))
        col.append(c[ok].astype(np.float64))
    keys = np.concatenate(keys)
    uniq, inv = np.unique(keys, return_inverse=True)
    out = [np.zeros((len(uniq), 3)) for _ in range(2)]
    np.add.at(out[0], inv, np.concatenate(nrm))
    np.add.at(out[1], inv, np.concatenate(col))
    return uniq, out[0], out[1], np.bincount(inv)


def _port_sums64(vm):
    """The port's exact sums as float64 (C, 10)."""
    return vm.sums.t().to(torch.float64).numpy() / 2.0 ** 32


def _assert_store_matches(t, j, scans=None):
    """Keys, counts and base exact; means within 1e-5 m; colour and normal
    sums by the rule in the module docstring (with ``scans``, the float64
    reference).  Returns the valid mask."""
    tk, jk = t.keys.numpy(), np.asarray(j.keys)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(t.region_base.numpy(), np.asarray(j.region_base))
    v = tk != INT32_MAX
    np.testing.assert_array_equal(t.count.numpy()[v], np.asarray(j.count)[v])
    np.testing.assert_allclose(t._means().numpy()[v], np.asarray(j._means())[v],
                               atol=POS_TOL_M, rtol=0)
    # Empty slots hold zero sums.
    assert not t.sums[:, ~torch.from_numpy(v)].any()
    if scans is not None:
        keys, nrm64, col64, cnt = _f64_sums(scans, t.voxel_size, t.region_base.numpy())
        np.testing.assert_array_equal(tk[v], keys)
        np.testing.assert_array_equal(t.count.numpy()[v], cnt)
        s64 = _port_sums64(t)[v]
        for port, jax_, ref in ((s64[:, 3:6], np.asarray(j.normal_sum)[v], nrm64),
                                (s64[:, 6:9], np.asarray(j.color_sum)[v], col64)):
            np.testing.assert_allclose(port, ref, atol=SUM_TOL, rtol=0)
            assert np.all(np.abs(port - jax_) <= np.abs(jax_ - ref) + SUM_TOL)
    return v


def _boundary_voxels(means, keys, vs, base):
    """Valid voxels whose float32 mean keys to another voxel."""
    coords = np.floor(means / np.float32(vs)).astype(np.int64) - base.astype(np.int64)
    e = tvox.EXACT_EXTENT
    return int(np.sum(((coords[:, 0] * e + coords[:, 1]) * e + coords[:, 2]) != keys))


def _inserted(rng, n_scans=3):
    scans = [_scan(rng) for _ in range(n_scans)]
    scans.append(scans[0])           # the same cloud again: merged, not new
    jv, tv = jdm.empty(16384, VS), tdm.empty(16384, VS, device="cpu")
    for pts, mask, nrm, col in scans:
        jc, tc = _pair(pts, mask, nrm, col)
        jv, tv = jdm.insert(jv, jc), tdm.insert(tv, tc)
    return scans, jv, tv


def test_insert_matches_jax(rng):
    scans, jv, tv = _inserted(rng)
    v = _assert_store_matches(tv, jv, scans)
    assert int(tv.num_voxels()) == int(jv.num_voxels()) == int(v.sum()) > 4000
    assert (tv.keys.numel() * tv.keys.element_size() + tv.sums.numel() *
            tv.sums.element_size()) == tdm.BYTES_PER_VOXEL * 16384 == 84 * 16384
    # Means stay in their voxel, up to the counted boundary voxels.
    n_port = _boundary_voxels(tv._means().numpy()[v], tv.keys.numpy()[v], VS,
                              tv.region_base.numpy())
    n_jax = _boundary_voxels(np.asarray(jv._means())[v], np.asarray(jv.keys)[v], VS,
                             np.asarray(jv.region_base))
    assert n_port <= 2 and n_jax <= 2, (n_port, n_jax)


def test_insert_overflow_keeps_smallest_keys(rng):
    """More voxels than the capacity: both keep the smallest keys."""
    pts, mask, nrm, col = _scan(rng, n=2048, extent=1.0, valid=1.0)
    jc, tc = _pair(pts, mask, nrm, col)
    jv, tv = jdm.insert(jdm.empty(512, VS), jc), tdm.insert(tdm.empty(512, VS, "cpu"), tc)
    v = _assert_store_matches(tv, jv)
    assert v.all()


def test_hash_collision_not_merged():
    """Voxels whose coords differ by (-152, -951, -211) collide in the
    additive int32 hash; the exact keys keep them apart
    (``tests/test_pipeline_units.py``'s store regression)."""
    a = np.array([5.5, 0.5, 0.5], np.float32)
    b = a + np.array([-152, -951, -211], np.float32)
    jc, tc = _pair(np.stack([a, b]))
    jv, tv = jdm.insert(jdm.empty(64, 1.0), jc), tdm.insert(tdm.empty(64, 1.0, "cpu"), tc)
    _assert_store_matches(tv, jv)
    assert int(tv.num_voxels()) == 2
    out = tpc.to_numpy(tdm.to_point_cloud(tv))["points"]
    np.testing.assert_allclose(sorted(map(tuple, out)), sorted(map(tuple, np.stack([a, b]))),
                               atol=1e-4)


def test_out_of_region_points_dropped():
    jv, tv = jdm.empty(64, 1.0), tdm.empty(64, 1.0, "cpu")
    for p in ([[0.5, 0.5, 0.5]], [[5000.0, 0.5, 0.5]]):
        jc, tc = _pair(np.array(p, np.float32))
        jv, tv = jdm.insert(jv, jc), tdm.insert(tv, tc)
    _assert_store_matches(tv, jv)
    assert int(tv.num_voxels()) == 1


def test_empty_first_insert_anchors_base_as_jax():
    """A first insert with no valid point still anchors the base, at the
    voxel mean of nothing (0), as the JAX package does."""
    pts = np.zeros((8, 3), np.float32)
    jc, tc = _pair(pts, mask=np.zeros(8, bool))
    jv, tv = jdm.insert(jdm.empty(16, 1.0), jc), tdm.insert(tdm.empty(16, 1.0, "cpu"), tc)
    _assert_store_matches(tv, jv)
    assert int(tv.num_voxels()) == 0


def test_remove_keys_matches_jax():
    pts = np.array([[0.5, 0.5, 0.5], [5.5, 5.5, 5.5]], np.float32)
    jc, tc = _pair(pts)
    jv, tv = jdm.insert(jdm.empty(256, 1.0), jc), tdm.insert(tdm.empty(256, 1.0, "cpu"), tc)
    jbase = jvox.region_base_from_center(jnp.zeros(3, jnp.int32))
    tbase = tvox.region_base_from_center(torch.zeros(3, dtype=torch.int32))
    jkey = jvox.pack_coords(jvox.voxel_coords(jnp.asarray(pts[:1]), 1.0), jbase)
    tkey = tvox.pack_coords(tvox.voxel_coords(torch.from_numpy(pts[:1]), 1.0), tbase)
    assert int(jkey[0]) == int(tkey[0])
    jv = jdm.remove_keys(jv, jnp.sort(jkey), jbase)
    tv = tdm.remove_keys(tv, torch.sort(tkey).values, tbase)
    _assert_store_matches(tv, jv)
    np.testing.assert_allclose(tpc.to_numpy(tdm.to_point_cloud(tv))["points"],
                               [[5.5, 5.5, 5.5]], atol=1e-5)


def test_carved_voxel_keys_match_jax(rng):
    pts, mask, _, _ = _scan(rng, n=512, center=(4.0, 1.0, 0.5), extent=2.0)
    jc, tc = _pair(pts, mask)
    sensor = np.float32([0.3, -0.2, 0.1])
    jk, jb = jcarv.carved_voxel_keys(jc, jnp.asarray(sensor), VS, 0.1, 0.1, 6.0,
                                     max_steps=31)
    tk, tb = tcarv.carved_voxel_keys(tc, torch.from_numpy(sensor), VS, 0.1, 0.1, 6.0,
                                     max_steps=31)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tcarv.face_neighbor_deltas("cpu").numpy(),
                                  np.asarray(jcarv.FACE_NEIGHBOR_DELTAS))


def _wall_store(rng, x):
    """A store holding a wall at ``x`` and points in front of it."""
    wall = np.stack([np.full(3000, x), rng.uniform(-1, 1, 3000),
                     rng.uniform(-1, 1, 3000)], axis=1).astype(np.float32)
    free = (wall * rng.uniform(0.3, 0.9, (3000, 1))).astype(np.float32)
    jv, tv = jdm.empty(16384, VS), tdm.empty(16384, VS, "cpu")
    for cloud in (wall, free):
        jc, tc = _pair(cloud)
        jv, tv = jdm.insert(jv, jc), tdm.insert(tv, tc)
    return wall, jv, tv


def _n_boundary(vm, means):
    v = np.asarray(vm.keys) != INT32_MAX
    return _boundary_voxels(np.asarray(means)[v], np.asarray(vm.keys)[v], VS,
                            np.asarray(vm.region_base))


def test_carving_removes_face_neighbourhoods_as_jax(rng):
    """Rays from the origin through a wall 4 m out and past it: the voxels
    the rays pass (and their face neighbours) go, in both."""
    wall, jv, tv = _wall_store(rng, 4.013)
    assert _n_boundary(jv, jv._means()) == _n_boundary(tv, tv._means().numpy()) == 0
    before = int(tv.num_voxels())
    rays = (wall[:600] * np.float32(1.05)).astype(np.float32)
    jc, tc = _pair(rays)
    sensor = np.zeros(3, np.float32)
    jk, jb = jcarv.carved_voxel_keys(jc, jnp.asarray(sensor), VS, 0.1, 0.1, 20.0,
                                     max_steps=101)
    tk, tb = tcarv.carved_voxel_keys(tc, torch.from_numpy(sensor), VS, 0.1, 0.1, 20.0,
                                     max_steps=101)
    jv = jdm.remove_keys(jv, jk, jb, neighbor_deltas=jcarv.FACE_NEIGHBOR_DELTAS)
    tv = tdm.remove_keys(tv, tk, tb, neighbor_deltas=tcarv.face_neighbor_deltas("cpu"))
    _assert_store_matches(tv, jv)
    assert 0 < int(tv.num_voxels()) < before


def test_means_on_voxel_faces_stay_in_their_voxel(rng):
    """A wall exactly on a voxel face (x = 4.0 = 80 voxels): the port's
    exact sums rebuild every mean inside its voxel; the JAX package's float32
    running sum puts some an ulp outside (3.9999995), so its carving re-keys
    them to the neighbouring voxel (ROADMAP §3).  Counted, not tolerated."""
    _, jv, tv = _wall_store(rng, 4.0)
    _assert_store_matches(tv, jv)
    n_jax = _n_boundary(jv, jv._means())
    assert _n_boundary(tv, tv._means().numpy()) == 0
    assert n_jax > 0


def test_transform_matches_jax(rng):
    """Means, normals and colours moved; keys re-derived from the moved means
    and the base re-anchored.  Two voxels may share a key after a rotation
    (the next insert merges them), and a stable and an unstable sort may
    order such a pair differently, so rows are compared by key."""
    _, jv, tv = _inserted(rng)
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.array([[c, -s, 0, 1.0], [s, c, 0, -2.0], [0, 0, 1, 0.5], [0, 0, 0, 1]],
                 np.float32)
    jt, tt = jdm.transform(jv, jnp.asarray(T)), tdm.transform(tv, torch.from_numpy(T))
    np.testing.assert_array_equal(tt.region_base.numpy(), np.asarray(jt.region_base))
    tk, jk = tt.keys.numpy(), np.asarray(jt.keys)
    np.testing.assert_array_equal(tk, jk)
    v = tk != INT32_MAX
    jo, to = np.argsort(jk[v], kind="stable"), np.argsort(tk[v], kind="stable")
    same = np.r_[True, jk[v][1:] != jk[v][:-1]] & np.r_[jk[v][1:] != jk[v][:-1], True]
    tm, jm = tt._means().numpy()[v][to], np.asarray(jt._means())[v][jo]
    np.testing.assert_allclose(tm[same], jm[same], atol=POS_TOL_M, rtol=0)
    np.testing.assert_array_equal(tt.count.numpy()[v][to][same],
                                  np.asarray(jt.count)[v][jo][same])
    tcol = tpc.to_numpy(tdm.to_point_cloud(tt))["colors"][to]
    jcol = np.asarray(jdm.to_point_cloud(jt).colors)[v][jo]
    np.testing.assert_allclose(tcol[same], jcol[same], atol=1e-3)


def test_to_point_cloud_matches_jax(rng):
    """Means within 1e-5 m of JAX's; normals (normalised sums) and colours
    (sums / count) within 1e-6 of the same from the float64 sums, and no
    farther from JAX's than JAX's are from those, plus 1e-6 (a voxel whose
    normals nearly cancel magnifies JAX's rounding of their sum)."""
    scans, jv, tv = _inserted(rng)
    jp, tp = jdm.to_point_cloud(jv), tdm.to_point_cloud(tv)
    m = tp.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(jp.mask))
    np.testing.assert_allclose(tp.points.numpy()[m], np.asarray(jp.points)[m],
                               atol=POS_TOL_M, rtol=0)
    assert not tp.points.numpy()[~m].any()
    _, nrm64, col64, cnt = _f64_sums(scans, VS, tv.region_base.numpy())
    nlen = np.linalg.norm(nrm64, axis=1, keepdims=True)
    for port, jax_, ref in ((tp.normals.numpy()[m], np.asarray(jp.normals)[m],
                             np.where(nlen > 1e-9, nrm64 / np.maximum(nlen, 1e-9), 0.0)),
                            (tp.colors.numpy()[m], np.asarray(jp.colors)[m],
                             col64 / cnt[:, None])):
        np.testing.assert_allclose(port, ref, atol=SUM_TOL, rtol=0)
        assert np.all(np.abs(port - jax_) <= np.abs(jax_ - ref) + SUM_TOL)


def test_remove_duplicate_points_matches_jax(rng):
    pts = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    mask = rng.uniform(size=2048) < 0.8
    jc, tc = _pair(pts, mask)
    want = np.asarray(jvox.remove_duplicate_points_in_voxels(jc, 0.2).mask)
    got = tvox.remove_duplicate_points_in_voxels(tc, 0.2).mask.numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()


@pytest.mark.parametrize("voxel", [0.3, 0.0])
def test_voxelize_within_cropping_volume_matches_jax(rng, voxel):
    pts = rng.uniform(-4, 4, (2048, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
    mask = rng.uniform(size=2048) < 0.9
    inside = np.linalg.norm(pts, axis=1) < 2.5
    jc, tc = _pair(pts, mask, colors=col)
    want = jvox.voxelize_within_cropping_volume(jc, voxel, jnp.asarray(inside))
    got = tvox.voxelize_within_cropping_volume(tc, voxel, torch.from_numpy(inside))
    m = got.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(want.mask))
    np.testing.assert_allclose(got.points.numpy()[m], np.asarray(want.points)[m],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.colors.numpy()[m], np.asarray(want.colors)[m],
                               atol=2048 * 2.0 ** -22, rtol=0)
    outside = m & (np.linalg.norm(got.points.numpy(), axis=1) >= 2.5 + 1e-3)
    # Points outside the volume pass through bit-exact.
    np.testing.assert_array_equal(got.points.numpy()[outside],
                                  np.asarray(want.points)[outside])
    np.testing.assert_array_equal(tvox.voxel_centers(torch.tensor([[1, -2, 3]]), 0.5).numpy(),
                                  np.asarray(jvox.voxel_centers(jnp.asarray([[1, -2, 3]]), 0.5)))


def test_compact_and_concat_match_jax(rng):
    pts = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.6
    ja, ta = _pair(pts, mask, normals=nrm)
    jb, tb = _pair(pts[:200] + 5.0, mask[100:], colors=np.abs(nrm[:200]))
    for got, want in ((tpc.compact(ta), jpc.compact(ja)),
                      (tpc.concat(ta, tb, 512), jpc.concat(ja, jb, 512)),
                      (tpc.concat(ta, tb, 128), jpc.concat(ja, jb, 128))):
        for k in ("points", "mask", "normals", "colors"):
            a, b = getattr(got, k), getattr(want, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


def test_estimate_covariances_matches_jax(rng):
    """GICP covariances from normals on the kernel route; the ill-posed
    normals of ``test_torch_normals.py`` (1% allowed) move their
    covariance, so 99% must agree within 1e-3."""
    ground = np.stack([rng.uniform(-4, 4, 320), rng.uniform(-4, 4, 320), np.zeros(320)], 1)
    wall = np.stack([np.full(192, 2.0), rng.uniform(-4, 4, 192), rng.uniform(0, 3, 192)], 1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    pts += rng.normal(scale=0.005, size=pts.shape).astype(np.float32)
    with jax_kernel_path():
        want = np.asarray(jn.estimate_covariances(jpc.from_numpy(pts), 0.8, max_nn=12))
    got = tn.estimate_covariances(tpc.from_numpy(pts), 0.8, max_nn=12).numpy()
    n = len(pts)
    close = np.abs(got[:n] - want[:n]).reshape(n, -1).max(axis=1) <= 1e-3
    assert close.mean() >= 0.99, np.sort(np.abs(got[:n] - want[:n]).reshape(n, -1).max(1))[-8:]


def _submap_params():
    p = small_jax_params()
    p.capacities.dense_submap_voxels = 16384
    p.mapper.is_build_dense_map = True
    b = p.mapper.dense_map_builder
    b.map_voxel_size = 0.1
    b.cropper.cropping_max_radius = 8.0
    b.carving.carve_space_every_n_scans = 2
    b.carving.max_raytracing_length = 8.0
    return p


def test_submap_insert_scan_dense_map_matches_jax(rng):
    """``Submap.insert_scan_dense_map`` over handed-over scans and poses,
    with a carve at the second and fourth scans (cadence 2), then a
    loop-closure ``transform`` of the whole submap."""
    jp = _submap_params()
    tp = to_torch_params(jp)
    cap = jp.capacities.dense_submap_voxels
    js = JaxSubmap(0, 0, jp.mapper, map_capacity=1024, dense_capacity=cap)
    ts = Submap(0, 0, tp.mapper, map_capacity=1024, dense_capacity=cap, device="cpu")
    assert ts.dense_map.capacity == cap and ts.dense_map.voxel_size == 0.1
    world = np.concatenate([
        np.stack([rng.uniform(-6, 6, 4000), rng.uniform(-6, 6, 4000), np.zeros(4000)], 1),
        np.stack([np.full(2000, 5.0), rng.uniform(-6, 6, 2000), rng.uniform(0, 3, 2000)], 1)])
    world += rng.normal(scale=0.01, size=world.shape)     # off the voxel faces
    removed = []
    for i in range(5):
        pose = np.eye(4)
        pose[:3, 3] = [0.3 * i, 0.1 * i, 1.0]
        sel = rng.choice(len(world), 2048, replace=False)
        pts = (world[sel] - pose[:3, 3]).astype(np.float32)
        if i == 2:      # a stale object in free space, carved at scan 3
            pts[:200] = (pts[:200] * 0.5).astype(np.float32)
        col = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
        jc, tc = _pair(pts, colors=col)
        before = int(ts.dense_map.num_voxels())
        js.insert_scan_dense_map(jc, pose, 0.1 * i)
        ts.insert_scan_dense_map(tc, pose, 0.1 * i)
        _assert_store_matches(ts.dense_map, js.dense_map)
        removed.append(before - int(ts.dense_map.num_voxels()))
    assert ts.n_scans_inserted_dense == js.n_scans_inserted_dense == 5
    # Carving emptied voxels at scan 3, whose rays pass the stale object.
    assert removed[3] > 0, removed
    T = np.eye(4)
    T[:3, 3] = [0.2, -0.1, 0.0]
    js.transform(T)
    ts.transform(T)
    np.testing.assert_array_equal(ts.dense_map.keys.numpy(), np.asarray(js.dense_map.keys))
    np.testing.assert_array_equal(ts.dense_map.region_base.numpy(),
                                  np.asarray(js.dense_map.region_base))
    assert int(ts.dense_map.num_voxels()) > 0
    # No dense store where the configuration builds none.
    tp.mapper.is_build_dense_map = False
    assert Submap(1, 0, tp.mapper, map_capacity=1024, device="cpu").dense_map is None


def test_dense_store_costs_no_host_sync(rng):
    """Insert, carve and transform pull nothing to the host."""
    tp = to_torch_params(_submap_params())
    ts = Submap(0, 0, tp.mapper, map_capacity=1024, dense_capacity=4096, device="cpu")
    before = tdevice.host_syncs.count
    for i in range(3):
        pts = rng.uniform(-3, 3, (1024, 3)).astype(np.float32)
        ts.insert_scan_dense_map(tpc.from_numpy(pts), np.eye(4), 0.1 * i)
    ts.transform(np.eye(4))
    assert tdevice.host_syncs.count == before


def _structured(rng, n, colored=False, with_normals=False, intensity=False):
    fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    if with_normals:
        fields += [(f"normal_{a}", np.float32) for a in "xyz"]
    if colored:
        fields += [("rgb", np.float32)]
    if intensity:
        fields += [("intensity", np.float32)]
    arr = np.zeros(n, dtype=fields)
    arr["x"], arr["y"], arr["z"] = rng.normal(size=(3, n)).astype(np.float32)
    if with_normals:
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        arr["normal_x"], arr["normal_y"], arr["normal_z"] = nrm.T
    if colored:
        c = rng.integers(0, 256, size=(n, 3)).astype(np.uint32)
        arr["rgb"] = ((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]).view(np.float32)
    if intensity:
        arr["intensity"] = rng.uniform(0, 100, n).astype(np.float32)
    return arr


@pytest.mark.parametrize("kind", ["plain", "colored", "normals", "intensity"])
def test_structured_conversions_match_jax(rng, kind):
    """Structured arrays <-> PointCloud, as ``tests/test_conversions.py``:
    the clouds and the structured arrays back are bit-equal to JAX's."""
    arr = _structured(rng, 100, colored=kind == "colored",
                      with_normals=kind == "normals", intensity=kind == "intensity")
    got = tconv.structured_to_pointcloud(arr, device="cpu")
    want = jconv.structured_to_pointcloud(arr)
    for k in ("points", "mask", "normals", "colors"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    back, jback = tconv.pointcloud_to_structured(got), jconv.pointcloud_to_structured(want)
    assert back.dtype == jback.dtype
    np.testing.assert_array_equal(back.view(np.uint8), jback.view(np.uint8))
    for f in arr.dtype.names:
        if f in back.dtype.names:
            np.testing.assert_array_equal(back[f].view(np.uint32), arr[f].view(np.uint32))
    if kind == "intensity":
        c = tpc.to_numpy(got)["colors"]
        np.testing.assert_array_equal(c[:, 0], c[:, 1])
        assert c.max() <= 1.0


def test_structured_conversion_defaults_to_the_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconv.structured_to_pointcloud(_structured(rng, 8))


def test_mesh_polygon_msg_round_trip_matches_jax(rng):
    v = rng.normal(size=(50, 3)).astype(np.float32)
    t = rng.integers(0, 50, size=(80, 3)).astype(np.int32)
    c = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    msg = tconv.mesh_to_polygon_msg(tconv.TriangleMesh(v, t, vertex_colors=c))
    jmsg = jconv.mesh_to_polygon_msg(jconv.TriangleMesh(v, t, vertex_colors=c))
    np.testing.assert_array_equal(msg["cloud"].view(np.uint8), jmsg["cloud"].view(np.uint8))
    np.testing.assert_array_equal(msg["polygons"], jmsg["polygons"])
    back, jback = tconv.polygon_msg_to_mesh(msg), jconv.polygon_msg_to_mesh(jmsg)
    np.testing.assert_array_equal(back.vertices, jback.vertices)
    np.testing.assert_array_equal(back.triangles, t)
    np.testing.assert_array_equal(back.vertex_colors, jback.vertex_colors)
    np.testing.assert_allclose(back.vertex_colors, c, atol=1.0 / 255.0 + 1e-6)
    msg["polygons"] = np.array([[0, 1, 99]], np.int32)
    with pytest.raises(ValueError):
        tconv.polygon_msg_to_mesh(msg)


def test_submap_palette_matches_jax():
    np.testing.assert_array_equal(tcolors.PALETTE, jcolors.PALETTE)
    for i in (0, 5, 12, 25):
        np.testing.assert_array_equal(tcolors.submap_color(i), jcolors.submap_color(i))
