"""Port vs JAX: kernel K3 (``nn_argmin``), the hash grid built on it, and
the voxel overlap masks of the loop-closure path.

K3 takes the expansion form |q|^2 + |t|^2 - 2 q.t, whose float32 rounding
can swap two targets at nearly the same distance.  So the indices must be
equal wherever the two best candidates' exact distances differ by more than
1e-5 relative, and elsewhere the port's pick must be one of those near-ties.
``hashgrid.query_nearest`` recomputes the winner's exact d2: its ``found``
masks must be equal and the d2 agree to 1e-6 relative.  The grid's hashes,
order and the overlap masks are integer results and must be bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.ops import hashgrid as jgrid, overlap as joverlap, pallas_knn
from open3d_slam_tpu.ops import voxel as jvox
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.ops import cuda_knn, hashgrid as tgrid, overlap as toverlap
from open3d_slam_torch.ops import voxel as tvox
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import jax_kernel_path

TIE_RTOL = 1e-5      # K3 index parity outside near-ties
D2_RTOL = 1e-6       # query_nearest exact d2


def _clouds(pts, mask, normals=None):
    j = jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask),
                       normals=None if normals is None else jnp.asarray(normals))
    t = tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                       normals=None if normals is None else torch.from_numpy(normals))
    return j, t


def _exact_d2(q, t):
    return ((q[:, None, :].astype(np.float64) - t[None, :, :]) ** 2).sum(-1)


def _assert_index_parity(q, t, valid, got, want):
    """Equal indices where the best two valid candidates differ by more than
    TIE_RTOL; elsewhere both picks lie within TIE_RTOL of the best."""
    d2 = np.where(valid[None, :], _exact_d2(q, t), np.inf)
    srt = np.sort(d2, axis=1)
    best, second = srt[:, 0], srt[:, 1]
    clear = (second - best) > TIE_RTOL * np.maximum(best, 1e-12)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got[clear], want[clear])
    rows = np.arange(len(q))
    for pick in (got, want):
        assert valid[pick].all()
        assert (d2[rows, pick] <= best + TIE_RTOL * np.maximum(best, 1e-12)).all()


@pytest.mark.parametrize("n_port", [4096, 3900])
def test_nn_argmin_plain_matches_pallas(rng, n_port):
    """512 queries x 4096 targets, a third of them masked.  The JAX kernel
    needs whole tiles; the port also runs on 3900 targets (a partial last
    tile on the card), which must give what JAX gives with the tail masked."""
    m, n = 512, 4096
    q = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    t = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.33
    valid[n_port:] = False
    t2 = np.where(valid, (t * t).sum(1), np.inf).astype(np.float32)
    with jax_kernel_path():
        j_idx, j_d2 = pallas_knn.nn_argmin(jnp.asarray(q), jnp.asarray(t.T),
                                           jnp.asarray(t2[None, :]),
                                           block_m=256, block_n=1024)
    j_idx, j_d2 = np.asarray(j_idx), np.asarray(j_d2)
    t_idx, t_d2 = cuda_knn.nn_argmin(torch.from_numpy(q),
                                     torch.from_numpy(np.ascontiguousarray(t[:n_port].T)),
                                     torch.from_numpy(t2[:n_port]))
    assert t_idx.dtype == torch.int32 and t_d2.dtype == torch.float32
    t_idx, t_d2 = t_idx.numpy(), t_d2.numpy()
    _assert_index_parity(q, t, valid, t_idx, j_idx)
    # The approximate d2 is the expansion at the picked index: equal up to
    # the rounding of |q|^2 + |t|^2 (JAX sums its dot on the MXU path).
    same = t_idx == j_idx
    scale = (q * q).sum(1) + (t * t).sum(1)[t_idx]
    assert (np.abs(t_d2 - j_d2)[same] <= 1e-6 * scale[same] + 1e-6).all()


def test_nn_argmin_plain_edges():
    """Every target masked -> index 0 and d2 +inf; exact ties -> the lowest
    index, as the Pallas kernel's argmin and strict update give."""
    q = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    t = torch.tensor([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 2.0], [2.0, 0.0, 0.0]])
    t2 = torch.full((4,), float("inf"))
    idx, d2 = cuda_knn.nn_argmin(q, t.t(), t2)
    assert idx.tolist() == [0, 0] and torch.isinf(d2).all()
    idx, d2 = cuda_knn.nn_argmin(q, t.t(), cuda_knn.squared_norms(t))
    assert idx.tolist() == [0, 0]
    assert d2.tolist() == [4.0, 3.0]


def test_hash_coords_wrap_like_int32(rng):
    c = np.concatenate([rng.integers(-40000, 40000, (2000, 3)),
                        rng.integers(-2 ** 31 // 83492791, 2 ** 31 // 83492791,
                                     (2000, 3))]).astype(np.int32)
    want = np.asarray(jvox.hash_coords(jnp.asarray(c)))
    got = tvox.hash_coords(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_is_bit_equal(rng):
    """Hashes, the stable order of equal hashes, and the sorted points."""
    n = 4096
    pts = np.concatenate([rng.uniform(-3, 3, (n // 2, 3)),              # many per cell
                          rng.uniform(-900, 900, (n // 2, 3))]).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    j, t = _clouds(pts, mask, nrm)
    jg, tg = jgrid.build(j, 0.5), tgrid.build(t, 0.5)
    np.testing.assert_array_equal(tg.hashes_sorted.numpy(), np.asarray(jg.hashes_sorted))
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    np.testing.assert_array_equal(tg.points_sorted.numpy(), np.asarray(jg.points_sorted))
    np.testing.assert_array_equal(tg.normals_sorted.numpy(), np.asarray(jg.normals_sorted))


def test_query_nearest_matches_pallas_route(rng):
    m, n = 512, 4096
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.25
    q = (pts[rng.integers(0, n, m)] + rng.normal(0, 0.3, (m, 3))).astype(np.float32)
    j, t = _clouds(pts, mask)
    with jax_kernel_path():
        jg = jgrid.build(j, 1.0)
        j_idx, j_d2, j_found = (np.asarray(a) for a in
                                jgrid.query_nearest(jg, jnp.asarray(q), 0.6))
    tg = tgrid.build(t, 1.0)
    t_idx, t_d2, t_found = tgrid.query_nearest(tg, torch.from_numpy(q), 0.6)
    t_idx, t_d2, t_found = t_idx.numpy(), t_d2.numpy(), t_found.numpy()
    assert 0.2 < j_found.mean() < 0.95
    np.testing.assert_array_equal(t_found, j_found)
    np.testing.assert_allclose(t_d2[t_found], j_d2[j_found], rtol=D2_RTOL, atol=0)
    assert np.isinf(t_d2[~t_found]).all() and (t_idx[~t_found] == 0).all()
    sp = tg.points_sorted.numpy()
    valid = tg.hashes_sorted.numpy() != tgrid.INT32_MAX
    _assert_index_parity(q[t_found], sp, valid, t_idx[t_found], j_idx[j_found])


def test_query_radius_bruteforce_neighbour_sets(rng):
    """Exact hybrid radius + k: the same neighbour set for every query (the
    radius holds fewer points than k, so no k-th-place tie can differ)."""
    n = 2048
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    j, t = _clouds(pts, mask)
    jg, tg = jgrid.build(j, 1.0), tgrid.build(t, 1.0)
    j_idx, j_d2, j_ok = (np.asarray(a) for a in
                         jgrid.query_radius_bruteforce(jg, jnp.asarray(pts), 1.0,
                                                       max_neighbors=48))
    t_idx, t_d2, t_ok = (a.numpy() for a in
                         tgrid.query_radius_bruteforce(tg, torch.from_numpy(pts), 1.0,
                                                       max_neighbors=48))
    assert t_idx.shape == (n, 48) and t_idx.dtype == np.int32
    assert j_ok.sum(1).max() < 48 and j_ok.sum() > 5 * n
    for r in range(n):
        assert set(t_idx[r][t_ok[r]]) == set(j_idx[r][j_ok[r]]), r
    np.testing.assert_allclose(np.sort(np.where(t_ok, t_d2, 0), 1),
                               np.sort(np.where(j_ok, j_d2, 0), 1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("offset", [0.0, 0.37])
def test_overlapping_masks_exact(rng, offset):
    """Two overlapping clouds, the source moved by a small rigid motion."""
    n = 3000
    a = rng.uniform(-10, 6, (n, 3)).astype(np.float32)
    b = rng.uniform(-6, 10, (n, 3)).astype(np.float32)
    ma, mb = rng.uniform(size=n) > 0.1, rng.uniform(size=n) > 0.1
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [offset, -offset, 0.1]
    ja, ta = _clouds(a, ma)
    jb, tb = _clouds(b, mb)
    js, jt = joverlap.overlapping_masks(ja, jb, jnp.asarray(T), 2.0)
    ts, tt = toverlap.overlapping_masks(ta, tb, torch.from_numpy(T), 2.0)
    assert 0.1 < np.asarray(js).mean() < 0.9
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
