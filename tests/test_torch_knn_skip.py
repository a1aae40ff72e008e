"""Kernel K3's gated sweep (``csrc/knn.cu``), emulated in plain PyTorch.

The kernel skips every (64-query group, 64-target tile) pair whose box gap,
less the margin 2^-19 (|q|^2_max + |t|^2_max + gap), reaches r^2
(``nn_layout.tile_need(..., margin=True)``), sweeps the rest in the
expansion form, publishes a query's best only when it is at most
r^2 + 2^-19 (|q|^2 + r^2), and merges the splits by an order-preserving
integer key.  ``_kept_sweep`` does the same with ``nn_argmin_plain`` over the
kept tiles of each group.  The callers' verdict (``hashgrid.query_nearest``:
the winner's exact d2 within r, a valid target), and the index and
expansion-form d2 wherever it holds, must equal those of the full plain
sweep, bit for bit, on clouds made to break a skip that is not exact: queries
at 30-80 m range (the expansion form rounds by ~1e-3 m^2 there), targets at
r (1 +- 2^-20) and at r (1 +- 2^-12) from a query, tiles of duplicated
targets just past the gate, queries within millimetres of a target (negative
expansion d2), -0.0 coordinates, invalid and partial tiles, and B > 1 poses
sharing one query order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_tpu.ops import hashgrid as jgrid
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.models.cloud_registration import _prepare_target_fn
from open3d_slam_torch.ops import cuda_knn, hashgrid as tgrid, nn_layout
from open3d_slam_torch.utils import pointcloud as tpc, se3

from torch_parity import jax_kernel_path

INF = float("inf")


def _r2(r):
    return float(np.float32(r) * np.float32(r))


def _kept_sweep(queries, query_mask, layout, r):
    """(idx, e) (B, M) as the kernel gives them: per group, the plain sweep
    over its kept tiles' targets, then the publish limit; (0, +inf) where
    nothing is published.  Also the kept (B, groups, tiles) pairs."""
    b, m, _ = queries.shape
    r2 = _r2(r)
    mask_f = (torch.ones(m) if query_mask is None else query_mask.float()).reshape(-1, m, 1)
    need = nn_layout.tile_need(queries, mask_f.expand(b, m, 1).contiguous(), layout,
                               torch.tensor([[r2]]), margin=True)
    points, valid = cuda_knn.layout_targets(layout.target)
    n = points.shape[0]
    t2 = torch.where(valid, cuda_knn.squared_norms(points), INF)
    staged = layout.target.order.long()
    order = layout.query_order.long().expand(b, m)
    qmask = (torch.ones(b, m, dtype=torch.bool) if query_mask is None
             else query_mask.reshape(-1, m).expand(b, m))
    idx = torch.zeros(b, m, dtype=torch.int32)
    e = torch.full((b, m), INF)
    for bi in range(b):
        for g in range(need.shape[1]):
            qi = order[bi, g * nn_layout.GROUP:(g + 1) * nn_layout.GROUP]
            qi = qi[qmask[bi, qi]]
            if len(qi) == 0:
                continue
            kept = torch.zeros(n, dtype=torch.bool)
            kept[staged] = need[bi, g].repeat_interleave(nn_layout.TILE)[:n]
            q, q2, t_t, t2m = cuda_knn.knn_inputs(queries[bi, qi], points.t(),
                                                  torch.where(kept, t2, INF))
            gi, ge = cuda_knn.nn_argmin_plain(q, q2, t_t, t2m)
            limit = r2 + (q2 + r2) * 2.0 ** -19
            pub = ge <= limit
            idx[bi, qi] = torch.where(pub, gi, 0)
            e[bi, qi] = torch.where(pub, ge, INF)
    return idx, e, need


def _verdict(points, valid, queries, idx, e, r):
    """``hashgrid.query_nearest``'s gate: (found, exact d2) (B, M)."""
    return tgrid.gate(points, valid, queries, idx, e, r)


def _merge_key(e, idx):
    """The kernel's merge key of (e, index) in plain PyTorch: e's bits
    mapped to an integer in the floats' order (negative values every bit
    flipped, the others the sign bit set, -0.0 as +0.0), above the index.
    The kernel packs (order << 32 | index) into an unsigned 64-bit word;
    (order << 31 | index) is an int64 in the same order."""
    u = (e.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64) & 0xffffffff
    order = torch.where(u >= 1 << 31, u ^ 0xffffffff, u | (1 << 31))
    return (order << 31) | idx.to(torch.int64)


def _assert_kept_equals_full(queries, query_mask, layout, r, *, max_kept=1.0):
    """The emulated gated sweep against the full plain sweep."""
    points, valid = cuda_knn.layout_targets(layout.target)
    want_i, want_e = cuda_knn.nn_argmin_within_plain(queries, query_mask, layout)
    got_i, got_e, need = _kept_sweep(queries, query_mask, layout, r)
    want_f, _ = _verdict(points, valid, queries, want_i, want_e, r)
    got_f, got_d2 = _verdict(points, valid, queries, got_i, got_e, r)
    assert torch.equal(got_f, want_f)
    assert torch.equal(got_i[want_f], want_i[want_f])
    assert torch.equal(got_e[want_f].view(torch.int32), want_e[want_f].view(torch.int32))
    # Not found: nothing published, or a winner the gate rejects.
    rest = ~want_f
    assert bool(((got_e[rest] == INF) & (got_i[rest] == 0) | (got_d2[rest] > _r2(r))).all())
    assert float(need.float().mean()) <= max_kept
    return want_f, want_e, need


def _shell(rng, n, lo=30.0, hi=80.0):
    """Points on surface patches 30-80 m from the origin, as a spinning
    sensor sees them: a few walls, each a dense 2-D patch."""
    walls = []
    for k in range(8):
        az = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(lo, hi)
        c = np.array([rad * np.cos(az), rad * np.sin(az), rng.uniform(-2, 2)])
        u = np.array([-np.sin(az), np.cos(az), 0.0])
        v = np.array([0.0, 0.0, 1.0])
        s = rng.uniform(-3, 3, (n // 8, 2))
        walls.append(c + s[:, :1] * u + s[:, 1:] * v + rng.normal(0, 0.01, (n // 8, 3)))
    return np.concatenate(walls).astype(np.float32)


def _unit(rng, k):
    u = rng.normal(size=(k, 3))
    return u / np.linalg.norm(u, axis=1, keepdims=True)


def _grid_layout(pts, valid):
    grid = tgrid.HashGrid(hashes_sorted=torch.where(torch.from_numpy(valid), 0, tgrid.INT32_MAX)
                          .to(torch.int32), points_sorted=torch.from_numpy(pts),
                          normals_sorted=None, order=torch.arange(len(pts), dtype=torch.int32),
                          cell_size=1.0)
    return grid, tgrid.nearest_layout(grid)


@pytest.mark.parametrize("r", [0.3, 2.0])
def test_gated_skip_at_sensor_range_equals_full_sweep(rng, r):
    """Walls at 30-80 m, half the targets invalid in one block (whole
    invalid tiles) plus a few scattered, a partial last tile; queries
    scattered up to 2r off targets, within millimetres of targets (the
    expansion form goes negative), and at r (1 +- 2^-20) from targets."""
    n = 3000 + 37
    pts = _shell(rng, n - 37)
    pts = np.concatenate([pts, _shell(rng, 37 * 8)[:37]]).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-600:] = False
    valid[rng.choice(n - 600, 100, replace=False)] = False
    base = pts[rng.choice(np.flatnonzero(valid), 384)]
    k = len(base) // 3
    q = np.concatenate([
        base[:k] + rng.normal(0, r, (k, 3)),
        base[k:2 * k] + rng.uniform(-3e-3, 3e-3, (k, 3)),
        base[2 * k:] + (r * (1 + rng.choice([-1, 1], (k, 1)) * 2.0 ** -20)) * _unit(rng, k),
    ]).astype(np.float32)
    q[:5, 2] = -0.0
    qmask = torch.from_numpy(rng.uniform(size=len(q)) > 0.05)
    grid, target = _grid_layout(pts, valid)
    queries = torch.from_numpy(q)[None]
    layout = nn_layout.SweepLayout(target, nn_layout.query_order(queries, qmask[None]))
    found, e, need = _assert_kept_equals_full(queries, qmask, layout, r, max_kept=0.5)
    assert 0.3 < found.float().mean() < 0.95
    assert bool((e < 0).any())


def test_duplicate_tiles_just_past_the_gate():
    """Each probe: 64 queries at one point Q at 80 m, 128 copies of a target
    V at r (1 - 2^-12) from Q and 128 copies of a target W at r (1 + 2^-12),
    W's lower in index.  Every run of copies is a whole number of tiles, so
    each tile holds one point and its box is that point.  The expansion form
    rounds by ~1e-3 m^2 there, far more than the two distances differ, so W
    often wins the full sweep and fails the gate: a skip of W's tiles at the
    gate itself (no margin) would let V win and pass it."""
    rng = np.random.default_rng(3)
    r = 0.3
    probes = 24
    qs, tv, tw = [], [], []
    for p in range(probes):
        az = 2 * np.pi * p / probes
        Q = np.array([80 * np.cos(az), 80 * np.sin(az), 1.0])
        u, w = _unit(rng, 2)
        qs.append(np.repeat(Q[None], 64, 0))
        tv.append(np.repeat((Q + r * (1 - 2.0 ** -12) * u)[None], 128, 0))
        tw.append(np.repeat((Q + r * (1 + 2.0 ** -12) * w)[None], 128, 0))
    pts = np.concatenate(tw + tv).astype(np.float32)
    queries = torch.from_numpy(np.concatenate(qs).astype(np.float32))[None]
    grid, target = _grid_layout(pts, np.ones(len(pts), bool))
    layout = nn_layout.SweepLayout(target, nn_layout.query_order(
        queries, torch.ones(queries.shape[:2], dtype=torch.bool)))
    found, _, _ = _assert_kept_equals_full(queries, None, layout, r)
    # Both verdicts occur, so the gate and the skip are both exercised.
    assert 0 < int(found.sum()) < found.numel()


def test_shared_order_across_poses_and_ties(rng):
    """B = 3 poses of one source, one (M,) order (of the untransformed
    source) for all; duplicated targets (exact ties go to the lower index);
    a masked source point."""
    n = 2048
    tgt = _shell(rng, n, 30.0, 40.0)
    tgt[1024:1224] = tgt[:200]                  # duplicates, higher indices
    src = (tgt[rng.choice(n, 500)] + rng.normal(0, 0.05, (500, 3))).astype(np.float32)
    mask = torch.from_numpy(rng.uniform(size=500) > 0.1)
    T = torch.stack([se3.make_transform(se3.rpy_to_matrix(*torch.tensor(a)), torch.tensor(t))
                     for a, t in [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                                  ((0.0, 0.0, 0.01), (0.1, -0.05, 0.0)),
                                  ((0.01, 0.0, -0.02), (-0.2, 0.1, 0.02))]]).float()
    queries = se3.transform_points(T, torch.from_numpy(src)).contiguous()
    grid, target = _grid_layout(tgt, np.ones(n, bool))
    layout = nn_layout.SweepLayout(target, nn_layout.query_order(torch.from_numpy(src), mask))
    found, _, _ = _assert_kept_equals_full(queries, mask, layout, 0.5, max_kept=0.5)
    assert found.float().mean() > 0.5
    want_i, _ = cuda_knn.nn_argmin_within_plain(queries, mask, layout)
    dup = (want_i >= 1024) & (want_i < 1224)
    assert not bool(dup[found].any())


def test_all_invalid_targets_find_nothing(rng):
    pts = _shell(rng, 704)
    grid, target = _grid_layout(pts, np.zeros(704, bool))
    queries = torch.from_numpy(pts[:100].copy())[None]
    layout = nn_layout.SweepLayout(target, torch.arange(100, dtype=torch.int32))
    got_i, got_e, need = _kept_sweep(queries, None, layout, 1.0)
    assert not bool(need.any())
    assert int(got_i.abs().max()) == 0 and bool(torch.isinf(got_e).all())
    want_i, want_e = cuda_knn.nn_argmin_within_plain(queries, None, layout)
    assert int(want_i.abs().max()) == 0 and bool(torch.isinf(want_e).all())


def test_merge_key_orders_like_argmin(rng):
    """The key's order is (e, index): negatives below zero, -0.0 equal to
    +0.0 (the lower index wins, as torch.argmin picks it), +inf last."""
    vals = torch.tensor([-3.0e-4, -0.0, 0.0, 1e-38, 2.5e-4, -1e-45, 7.0, INF, -1e3, 0.0,
                         -0.0, 7.0, INF, 1e-45], dtype=torch.float32)
    for _ in range(50):
        e = vals[torch.from_numpy(rng.permutation(len(vals)))][:int(rng.integers(1, 15))]
        idx = torch.arange(len(e))
        keys = _merge_key(e, idx)
        assert int(torch.argmin(keys)) == int(torch.argmin(e))
        assert torch.equal(torch.argsort(keys), torch.argsort(e, stable=True))
    both = _merge_key(torch.tensor([-0.0, 0.0]), torch.tensor([1, 0]))
    assert int(both[1]) < int(both[0])
    assert int(_merge_key(torch.tensor([3.4e38]), torch.tensor([2 ** 31 - 1]))) < \
        int(_merge_key(torch.tensor([INF]), torch.tensor([0])))


def test_query_nearest_batched_with_layout_matches_jax(rng):
    """(B, M, 3) queries with the source's order, a mask and a layout taken
    from K1's target layout of the same cloud, against the JAX package's
    query_nearest on each pose's queries (its kernel path)."""
    n, m = 2048, 256
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    pc = tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                        normals=torch.from_numpy(np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)))
    prepared = _prepare_target_fn(pc, 1.0, with_covs=True, with_kernel_target=True)
    layout = prepared.nearest_layout()
    assert torch.equal(layout.pts, tgrid.nearest_layout(prepared.grid).pts)
    src = (pts[rng.integers(0, n, m)] + rng.normal(0, 0.3, (m, 3))).astype(np.float32)
    smask = torch.from_numpy(rng.uniform(size=m) > 0.1)
    shifts = np.array([[0.0, 0.0, 0.0], [0.2, -0.1, 0.0]], np.float32)
    q = torch.from_numpy(src[None] + shifts[:, None])
    order = nn_layout.query_order(torch.from_numpy(src), smask)
    idx, d2, found = tgrid.query_nearest(prepared.grid, q, 0.6, layout, order, smask)
    assert idx.shape == (2, m) and found.dtype == torch.bool
    jg = jgrid.build(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), 1.0)
    sp = np.asarray(jg.points_sorted)
    with jax_kernel_path():
        for b in range(2):
            j_idx, j_d2, j_found = (np.asarray(a) for a in
                                    jgrid.query_nearest(jg, jnp.asarray(q[b].numpy()), 0.6))
            j_found = j_found & smask.numpy()
            np.testing.assert_array_equal(found[b].numpy(), j_found)
            np.testing.assert_allclose(d2[b].numpy()[j_found], j_d2[j_found], rtol=1e-6)
            np.testing.assert_array_equal(pts[idx[b].numpy()[j_found]], sp[j_idx[j_found]])
    # A layout made for another grid is refused.
    other = _prepare_target_fn(pc, 1.0, with_covs=False)
    with pytest.raises(ValueError):
        tgrid.query_nearest(other.grid, q, 0.6, layout, order, smask)
