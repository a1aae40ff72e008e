"""The sweep layout of kernels K1 and K4 (``ops/nn_layout.py``) and the
sweep's visit order, skip and tie rule, emulated in plain PyTorch.

The CUDA sweep (``csrc/nn_sweep.cuh``) visits targets in Morton order, skips
(query group, target tile) pairs whose boxes lie farther apart than r, and
replaces a running best on d <= best when d < best or the grid index is
lower; split 0 publishes every valid query's (d2, index), the other splits
only those with d2 <= r2, and the splits merge to the lexicographic minimum
(an integer atomicMin of the key (d2 bits, index) in the kernel, all ones
where none was published).  ``_emulate_sweep`` does the same, tile by tile
and target by target, split by split.  For every query whose nearest valid
target lies within r, its (d2, index) must equal ``_nn_plain``'s exactly
(both compute the same term-by-term rounded float32 distances;
``_nn_plain`` takes the first index of the minimum); every other valid query
gets some d2 > r2, which the row kernels read as no correspondence.
"""
import os

import numpy as np
import pytest
import torch

from open3d_slam_torch.ops import cuda_build, cuda_gicp as tg, cuda_icp as ti
from open3d_slam_torch.ops import nn_layout

BIG = 3.0e38
NONE = 1 << 32     # the index of an all-ones key: no split published one


def _decode(layout):
    """(xyz (..., N_pad, 3), grid index (..., N_pad)) of a target layout."""
    pts = layout.pts
    return pts[..., :3], pts.contiguous().view(torch.int32)[..., 3]


def _lattice(rng, shift=(0.0, 0.0, 0.0)):
    """A 10 x 10 x 7 lattice at 0.5 m in a random index order (700 targets,
    not a whole number of tiles), a tenth of it invalid."""
    g = np.stack(np.meshgrid(np.arange(10), np.arange(10), np.arange(7),
                             indexing="ij"), -1).reshape(-1, 3) * 0.5
    pts = (g[rng.permutation(len(g))] + np.asarray(shift)).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    return torch.from_numpy(pts), torch.from_numpy(valid)


def _queries(rng, tgt, m):
    """Queries a quarter lattice step off targets in x (exact ties between
    two lattice neighbours: d2 = 0.0625 to both), some at random points,
    some invalid."""
    base = tgt.numpy()[rng.choice(len(tgt), m)]
    q = base + np.asarray([0.25, 0.0, 0.0], np.float32)
    rand = rng.uniform(size=m) < 0.3
    q[rand] = rng.uniform(-0.5, 5.0, (int(rand.sum()), 3)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(rng.uniform(size=m) > 0.05)


def _emulate_sweep(q_pts, q_mask_f, layout, r2, splits):
    """(d2, index) (B, M) of the valid queries as the kernels' sweep and
    split merge give them; (inf, NONE) where no split published a key."""
    need = nn_layout.tile_need(q_pts, q_mask_f, layout, r2)
    b, m, _ = q_pts.shape
    valid = (q_mask_f.reshape(-1, m) > 0).expand(b, m)
    order = layout.query_order.long().expand(b, m)
    xyz, gidx = _decode(layout.target)
    n_tiles = need.shape[-1]
    part_d = torch.full((splits, b, m), float("inf"))
    part_i = torch.full((splits, b, m), NONE)
    for bi in range(b):
        txyz = xyz[bi] if xyz.dim() == 3 else xyz
        tidx = gidx[bi] if gidx.dim() == 2 else gidx
        for g in range(need.shape[1]):
            qi = order[bi, g * nn_layout.GROUP:(g + 1) * nn_layout.GROUP]
            q = q_pts[bi, qi]
            for s in range(splits):
                best = torch.full((len(qi),), BIG)
                arg = torch.zeros(len(qi), dtype=torch.int64)
                for t in range(s, n_tiles, splits):
                    if not need[bi, g, t]:
                        continue
                    for j in range(t * nn_layout.TILE, (t + 1) * nn_layout.TILE):
                        d0 = q[:, 0] - txyz[j, 0]
                        d1 = q[:, 1] - txyz[j, 1]
                        d2_ = q[:, 2] - txyz[j, 2]
                        d = (d0 * d0 + d1 * d1) + d2_ * d2_
                        take = (d <= best) & ((d < best) | (tidx[j] < arg))
                        best = torch.where(take, d, best)
                        arg = torch.where(take, tidx[j].long(), arg)
                publish = ((best <= r2.reshape(())) | (s == 0)) & valid[bi, qi]
                part_d[s, bi, qi] = torch.where(publish, best, part_d[s, bi, qi])
                part_i[s, bi, qi] = torch.where(publish, arg, part_i[s, bi, qi])
    best, arg = part_d[0], part_i[0]
    for s in range(1, splits):
        d, j = part_d[s], part_i[s]
        take = (d < best) | ((d == best) & (j < arg))
        best, arg = torch.where(take, d, best), torch.where(take, j, arg)
    return best, arg


@pytest.mark.parametrize("batched,n", [(False, 700), (False, 128), (True, 700)])
def test_target_layout_is_a_permutation_with_boxes_that_bound_their_points(rng, batched, n):
    pts, valid = _lattice(rng)
    pts, valid = pts[:n], valid[:n]
    if batched:
        pts = torch.stack([pts, pts + 3.0])
        valid = torch.stack([valid, ~valid])
    lay = nn_layout.target_layout(pts, valid)
    xyz, gidx = _decode(lay)
    n_pad = -(-n // nn_layout.TILE) * nn_layout.TILE
    assert lay.pts.shape[-2:] == (n_pad, 4) and lay.boxes.shape[-2:] == (n_pad // 64, 8)
    for e in range(2 if batched else 1):
        p, v = (pts[e], valid[e]) if batched else (pts, valid)
        x, i = (xyz[e], gidx[e]) if batched else (xyz, gidx)
        bx = lay.boxes[e] if batched else lay.boxes
        n_valid = int(v.sum())
        # A permutation of the targets, valid ones first, each staged at its
        # own position (invalid ones and the padding at the sentinel).
        assert sorted(i[:n].tolist()) == list(range(n))
        assert bool(v[i[:n_valid].long()].all()) and not bool(v[i[n_valid:n].long()].any())
        assert torch.equal(x[:n_valid], p[i[:n_valid].long()])
        assert bool((x[n_valid:] == nn_layout.SENTINEL).all())
        # Every box bounds the valid points of its tile; an all-invalid tile
        # has an empty box.
        tiles = x.reshape(-1, nn_layout.TILE, 3)
        live = (torch.arange(n_pad) < n_valid).reshape(-1, nn_layout.TILE)
        for t in range(tiles.shape[0]):
            if live[t].any():
                inside = tiles[t][live[t]]
                assert bool((inside >= bx[t, :3]).all() and (inside <= bx[t, 3:6]).all())
                assert torch.equal(inside.amin(0), bx[t, :3])
            else:
                assert bool((bx[t, :3] > bx[t, 3:6]).all())
        assert not bool(bx[:, 6:].any())


def test_query_order_is_a_morton_permutation(rng):
    q, qv = _queries(rng, _lattice(rng)[0], 300)
    order = nn_layout.query_order(q, qv)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(300))
    n_valid = int(qv.sum())
    assert bool(qv[order[:n_valid].long()].all()) and not bool(qv[order[n_valid:].long()].any())
    # A Morton group is compact: the mean box of 64 consecutive valid
    # queries is smaller than that of 64 queries in index order.
    def mean_extent(idx):
        g = q[idx[:n_valid // 64 * 64].long()].reshape(-1, 64, 3)
        return float((g.amax(1) - g.amin(1)).prod(-1).mean())
    assert mean_extent(order) < 0.5 * mean_extent(torch.nonzero(qv)[:, 0])
    # A cloud's layout as a target carries the same order, which odometry
    # reuses when the cloud becomes the next scan's source.
    assert torch.equal(nn_layout.target_layout(q, qv).order, order)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("shared", [True, False])
def test_emulated_sweep_equals_nn_plain_on_inliers(rng, splits, shared):
    """Three poses of one source: at the map, shifted by a lattice step, and
    off the map (no target within r: every group skips every tile)."""
    tgt, tvalid = _lattice(rng)
    q, qv = _queries(rng, tgt, 300)
    shifts = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.5, 0.0], [50.0, 0.0, 0.0]])
    q_pts = (q[None] + shifts[:, None]).contiguous()
    if shared:
        lay = nn_layout.target_layout(tgt, tvalid)
        order = nn_layout.query_order(q, qv)
        q_mask_f = qv.to(torch.float32)[:, None]
        targets = [(tgt, tvalid)] * 3
    else:
        tgt2, tvalid2 = _lattice(rng, shift=(0.0, 0.0, 0.25))
        stack = [(tgt, tvalid), (tgt2, tvalid2), (tgt, tvalid)]
        lay = nn_layout.target_layout(torch.stack([t for t, _ in stack]),
                                      torch.stack([v for _, v in stack]))
        masks = torch.stack([qv, qv, qv.roll(7)])
        order = nn_layout.query_order(q_pts, masks)
        q_mask_f = masks.to(torch.float32)[..., None]
        targets = stack
    layout = nn_layout.SweepLayout(lay, order)
    r2 = torch.full((1, 1), 0.09)
    got_d, got_i = _emulate_sweep(q_pts, q_mask_f, layout, r2, splits)
    n_ties = 0
    for e, (t, v) in enumerate(targets):
        want_d, want_i = ti._nn_plain(q_pts[e], t.t().contiguous(),
                                      v.to(torch.float32)[None])
        qm = q_mask_f.reshape(-1, 300)[0 if shared else e] > 0
        inl = (want_d <= 0.09) & qm
        assert torch.equal(got_d[e][inl], want_d[inl])
        assert torch.equal(got_i[e][inl], want_i[inl])
        assert bool((got_d[e][qm & ~inl] > 0.09).all() and (got_i[e][qm] != NONE).all())
        if e == 2:
            assert not bool(inl.any())
        n_ties += int((inl & (want_d == 0.0625)).sum())
    assert n_ties > 50
    need = nn_layout.tile_need(q_pts, q_mask_f, layout, r2)
    assert 0 < int(need.sum()) < need.numel() and not bool(need[2].any())


def test_planted_duplicates_resolve_to_the_lower_index_across_tiles():
    """Pairs of targets at equal distance from a query, in different tiles,
    the lower grid index on the one that comes later in Morton order."""
    rng = np.random.default_rng(3)
    tgt, tvalid = _lattice(rng)
    tvalid[:] = True
    lay = nn_layout.target_layout(tgt, tvalid)
    _, gidx = _decode(lay)
    rank = torch.empty(700, dtype=torch.int64)
    rank[gidx[:700].long()] = torch.arange(700)
    q = tgt + torch.tensor([0.25, 0.0, 0.0])
    right = torch.nonzero((tgt[None] == (tgt + torch.tensor([0.5, 0.0, 0.0]))[:, None]).all(-1))
    a, b = right[:, 0], right[:, 1]            # b is a's +x neighbour
    later_low = (b < a) & (rank[b] > rank[a]) & (rank[b] // 64 != rank[a] // 64)
    assert int(later_low.sum()) > 5
    q = q[a[later_low]]
    layout = nn_layout.SweepLayout(lay, nn_layout.query_order(q, torch.ones(len(q), dtype=torch.bool)))
    d, i = _emulate_sweep(q[None], torch.ones(len(q), 1), layout, torch.full((1, 1), 0.09), 2)
    assert bool((d == 0.0625).all()) and torch.equal(i[0], b[later_low])


def test_plain_versions_ignore_the_layout(rng):
    tgt, tvalid = _lattice(rng)
    q, qv = _queries(rng, tgt, 300)
    q_pts = torch.stack([q, q + 0.1]).contiguous()
    qm = qv.to(torch.float32)[:, None]
    nrm = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(700, 3)).astype(np.float32)), dim=1)
    r2 = torch.full((1, 1), 0.09)
    *target, t_lay = ti.prepare_target(tgt, nrm, tvalid)
    layout = nn_layout.SweepLayout(t_lay, nn_layout.query_order(q, qv))
    assert torch.equal(ti.p2l_normal_eq(q_pts, qm, *target, r2),
                       ti.p2l_normal_eq(q_pts, qm, *target, r2, layout))
    covs = torch.eye(3).repeat(700, 1, 1) * 0.01
    td, tv, g_lay = tg.prepare_target(tgt, covs, tvalid)
    qc = torch.zeros(2, 300, 6)
    layout = nn_layout.SweepLayout(g_lay, nn_layout.query_order(q, qv))
    want = tg.gicp_normal_eq(q_pts, qm, qc, td, tv, r2)
    assert float(want[:, 7, 0].min()) > 100
    assert torch.equal(want, tg.gicp_normal_eq(q_pts, qm, qc, td, tv, r2, None, layout))


def test_layout_that_does_not_fit_is_refused(rng):
    """A layout of the wrong size, or one not made with the call's own
    target arrays (another cloud of the same capacity, an unbound layout,
    arrays changed in place since), is refused."""
    cpu = torch.device("cpu")
    tgt, tvalid = _lattice(rng)
    nrm = torch.zeros_like(tgt)
    t_t, _, _, tv, lay = ti.prepare_target(tgt, nrm, tvalid)
    order = torch.arange(300, dtype=torch.int32)
    nn_layout.check_layout(nn_layout.SweepLayout(lay, order), 2, 300, 700, cpu, t_t, tv)
    other_t, _, _, other_v, other = ti.prepare_target(tgt + 1.0, nrm, tvalid)
    for bad in (nn_layout.SweepLayout(lay, order[:299]),
                nn_layout.SweepLayout(lay, order.long()),
                nn_layout.SweepLayout(nn_layout.target_layout(tgt[:600], tvalid[:600]),
                                      order),
                nn_layout.SweepLayout(other, order),
                nn_layout.SweepLayout(nn_layout.target_layout(tgt, tvalid), order)):
        with pytest.raises(ValueError):
            nn_layout.check_layout(bad, 2, 300, 700, cpu, t_t, tv)
    nn_layout.check_layout(nn_layout.SweepLayout(other, order), 2, 300, 700, cpu,
                           other_t, other_v)
    tv[0, 0] = 0.0
    with pytest.raises(ValueError):
        nn_layout.check_layout(nn_layout.SweepLayout(lay, order), 2, 300, 700, cpu, t_t, tv)


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """An edited header builds a new library, not a stale one."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define A 1\n")
    icp = os.path.join(cuda_build.CSRC_DIR, "icp.cu")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    first = cuda_build._lib_path("k")
    assert first == cuda_build._lib_path("k")
    (tmp_path / "b.cuh").write_text("#define A 2\n")
    second = cuda_build._lib_path("k")
    assert second != first
    assert [os.path.basename(p) for p in
            cuda_build._sources(str(tmp_path / "k.cu"), [])] == ["k.cu", "a.cuh", "b.cuh"]
    assert [os.path.basename(p) for p in cuda_build._sources(icp, [])] == [
        "icp.cu", "nn_sweep.cuh"]


_VIEWS = {"aten::reshape", "aten::view", "aten::expand", "aten::slice", "aten::unsqueeze",
          "aten::select", "aten::alias", "aten::as_strided", "aten::_reshape_alias"}


def _torch_ops(fn):
    """The top-level ATen operations ``fn`` runs, views left out: on the
    card each is one or a few kernel launches the host pays for."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("aten::")
            and e.name not in _VIEWS
            and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]


def test_layout_costs_few_torch_operations(rng):
    """The layout is made once per target (21 operations for a whole number
    of tiles, as the main path's capacities are) and once per registration
    call for the source (12; none for odometry's source, whose order is the
    previous target's): the replay is host-bound."""
    tgt, tvalid = _lattice(rng)
    tgt, tvalid = tgt[:640], tvalid[:640]
    q, qv = _queries(rng, tgt, 300)
    nn_layout.target_layout(tgt, tvalid)          # the Morton table, once per device
    assert len(_torch_ops(lambda: nn_layout.target_layout(tgt, tvalid))) <= 21
    assert len(_torch_ops(lambda: nn_layout.query_order(q, qv))) <= 12


# --- K2: the normals kernels on the same layout -----------------------------

from open3d_slam_torch.ops import cuda_normals as tcn  # noqa: E402

_F32 = torch.float32


def _kcap(k):
    return 8 if k <= 8 else 16 if k <= 16 else 32


def _sq_norm(x):
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def _box_gap2(tlo, thi, lo, hi):
    """nn::box_gap2 of tile boxes (T, 3) against one group box (3,)."""
    g = torch.clamp(torch.maximum(tlo - hi, lo - thi), min=0.0)
    return (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]


def _fma(a, b, c):
    """float32 fma(a, b, c), through float64 (exact product)."""
    return (a.double() * b.double() + c.double()).to(_F32)


def _groups(layout):
    order = layout.query_order.long()
    for g in range(-(-len(order) // nn_layout.GROUP)):
        yield order[g * nn_layout.GROUP:(g + 1) * nn_layout.GROUP]


def _listing_passes(need_of, n_tiles, threshold, start=0, stride=1, list_len=128):
    """The kernels' listing: from tile ``start`` in steps of ``stride``, 32
    candidates at a time, passes of at most ``list_len`` tiles, each pass
    tested against ``threshold()`` as it stands when the pass starts.
    Yields each pass's tiles."""
    cand = start
    while cand < n_tiles:
        t = threshold()
        listed = []
        while cand < n_tiles and len(listed) <= list_len - 32:
            ids = torch.arange(cand, min(cand + 32 * stride, n_tiles), stride)
            listed += ids[need_of(ids, t)].tolist()
            cand += 32 * stride
        yield listed


def _emulate_kth(query_points, points, mask, k, radius, layout, splits=1, list_len=128):
    """``kth_sweep`` and ``kth_merge`` of csrc/normals.cu in plain PyTorch.
    Per group and split: the tiles that overlap the group's box, whose k-th
    values give t0 (split 0 keeps their points, the others start anew);
    then the split's share of the other tiles (split, split + splits, ...)
    whose gap less the rounding margin is below the group's largest
    min(t0, k-th value), listed ``list_len`` at a time; a point enters a
    k-list only below min(t0, k-th value) (the k smallest of a multiset do
    not depend on the order within a tile).  The splits' k-lists merge to
    the k-th smallest of their union.  Also returns the (group, tile) pairs
    swept."""
    k = min(k, points.shape[0])
    cap = torch.tensor(float(radius), dtype=_F32) ** 2
    kc = _kcap(k)
    xyz = layout.target.pts[:, :3]
    boxes = layout.target.boxes
    tlo, thi = boxes[:, 0:3], boxes[:, 3:6]
    t2max = _sq_norm(torch.maximum(tlo.abs(), thi.abs()))
    tile_t2 = _sq_norm(xyz).reshape(-1, nn_layout.TILE)
    tiles = xyz.reshape(-1, nn_layout.TILE, 3)
    n_tiles = boxes.shape[0]
    out = torch.full((query_points.shape[0],), float("nan"))
    swept = 0
    for qi in _groups(layout):
        q = query_points[qi]
        lo, hi = q.amin(0), q.amax(0)
        q2 = _sq_norm(q)
        gq2 = _sq_norm(torch.maximum(lo.abs(), hi.abs()))
        g2_all = _box_gap2(tlo, thi, lo, hi)
        fresh = torch.cat([torch.full((len(qi), kc - k), -float("inf")),
                           cap.expand(len(qi), k)], dim=1)
        lists = []
        for split in range(splits):
            st = {"lst": fresh, "t0": cap.expand(len(qi))}

            def sweep(tile_ids):
                nonlocal swept
                for t in tile_ids:
                    v = tiles[t]
                    dot = _fma(q[:, None, 2], v[None, :, 2],
                               _fma(q[:, None, 1], v[None, :, 1],
                                    q[:, None, 0] * v[None, :, 0]))
                    d = (q2[:, None] + tile_t2[t][None, :]) - 2.0 * dot
                    d = torch.where(d < st["t0"][:, None], d, float("inf"))
                    st["lst"] = torch.sort(torch.cat([st["lst"], d], 1), 1).values[:, :kc]
                    swept += 1

            for listed in _listing_passes(lambda ids, t: g2_all[ids] <= 0.0, n_tiles,
                                          lambda: None, list_len=list_len):
                sweep(listed)
            st["t0"] = st["lst"][:, -1]
            if split > 0:
                st["lst"] = fresh

            def need(ids, t):
                g2 = g2_all[ids]
                margin = 2.0 ** -19 * ((gq2 + t2max[ids]) + g2)
                return (g2 > 0.0) & (g2 < nn_layout.SENTINEL) & (g2 - margin < t)

            def threshold():
                return torch.minimum(st["t0"], st["lst"][:, -1]).max()

            for listed in _listing_passes(need, n_tiles, threshold, split, splits, list_len):
                sweep(listed)
            lists.append(st["lst"][:, kc - k:])
        union = torch.sort(torch.cat(lists, 1), 1).values
        out[qi] = torch.clamp(union[:, k - 1], min=0.0)
    return out, swept


def _emulate_moments(query_points, points, mask, radius, layout):
    """``moments_sweep`` of csrc/normals.cu in plain PyTorch: queries and
    tiles centred on the layout's centroid, the tiles whose centred box lies
    within the group's largest r_q^2, summed tile by tile in list order.
    Returns (moments (M, 16), (group, tile) pairs swept)."""
    m = query_points.shape[0]
    c = layout.centroid
    r2 = tcn._per_query_r2(radius, m, points.device)
    tiles = (layout.target.pts[:, :3] - c).reshape(-1, nn_layout.TILE, 3)
    tlo, thi = layout.target.boxes[:, 0:3] - c, layout.target.boxes[:, 3:6] - c
    out = torch.zeros((m, 16))
    swept = 0
    for qi in _groups(layout):
        q = query_points[qi] - c
        lo, hi = q.amin(0), q.amax(0)
        t = r2[qi].max()
        need = _box_gap2(tlo, thi, lo, hi) <= t
        acc = torch.zeros((len(qi), 10))
        for tile in torch.nonzero(need)[:, 0].tolist():
            v = tiles[tile]
            d0 = q[:, None, 0] - v[None, :, 0]
            d1 = q[:, None, 1] - v[None, :, 1]
            d2_ = q[:, None, 2] - v[None, :, 2]
            w = ((d0 * d0 + d1 * d1) + d2_ * d2_ <= r2[qi][:, None]).to(_F32)
            x, y, z = v[:, 0], v[:, 1], v[:, 2]
            f = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y,
                             y * z, z * z], dim=1)
            # Sentinel rows never pass (d2 = inf): the kernel adds nothing
            # of them, so their overflowing features are left out here.
            acc = acc + w @ torch.where(torch.isfinite(f), f, 0.0)
            swept += 1
        out[qi, :10] = acc
    return out, swept


def _scan_like(rng, n, far=0.0):
    """A sensor-frame patch 20-30 m out (|q|^2 ~ 10^3, where the expansion
    form rounds d^2 by ~1e-4): ground and a wall, with exact duplicates."""
    half = n // 2
    ground = np.stack([rng.uniform(20, 30, half), rng.uniform(-5, 5, half),
                       np.full(half, -1.5)], axis=1)
    wall = np.stack([np.full(n - half, 25.0), rng.uniform(-5, 5, n - half),
                     rng.uniform(-1.5, 3.0, n - half)], axis=1)
    pts = np.concatenate([ground, wall]) + rng.normal(scale=0.01, size=(n, 3))
    pts[:40] = pts[40:80]                       # duplicated points: exact ties
    pts[-12:] += far                            # a far group of 12 < k points
    return torch.from_numpy(pts.astype(np.float32))


@pytest.mark.parametrize("case", ["self", "subset", "masked", "outliers", "k_above",
                                  "k_over_n"])
def test_emulated_kth_sweep_equals_plain(rng, case):
    """The prepass kernel's skip, listing and splits, emulated, give the
    plain version's values bit for bit (1, 3 and 8 splits; passes of 128
    tiles, the kernel's, and of 32): on a cloud against itself, at a query
    subset, with a masked support, with a far outlier group (fewer than k
    neighbours within r: exactly r^2), with k above the valid count, and
    with k above N (the N-th, as the JAX function takes it)."""
    n, k, radius = 2600, 20, 3.0
    pts = _scan_like(rng, n, far=200.0 if case == "outliers" else 0.0)
    mask = torch.ones(n, dtype=torch.bool)
    if case == "masked":
        mask = torch.from_numpy(rng.uniform(size=n) > 0.3)
    if case == "k_above":
        mask[:] = False
        mask[:12] = True
    if case == "k_over_n":
        pts, mask, k = pts[:25], mask[:25], 30
    q = pts
    if case == "subset":
        q = pts[torch.from_numpy(rng.choice(n, 700, replace=False))].contiguous()
    layout = tcn.normals_layout(q, pts, mask)
    cap = float(torch.tensor(radius, dtype=_F32) ** 2)
    want = tcn.kth_neighbor_d2_within_plain(q, pts, mask, min(k, len(pts)), cap)
    assert torch.equal(tcn.kth_neighbor_d2_within(q, pts, mask, k, radius, layout), want)
    for splits, list_len in ((1, 128), (1, 32), (3, 128), (8, 32)):
        got, n_swept = _emulate_kth(q, pts, mask, k, radius, layout, splits, list_len)
        assert torch.equal(got, want), (splits, list_len, (got - want).abs().max())
        if splits == 1:
            swept = n_swept
    n_tiles = layout.target.boxes.shape[0]
    groups = -(-q.shape[0] // nn_layout.GROUP)
    if case in ("self", "subset", "masked"):
        assert float(want.max()) < cap and swept < 0.7 * groups * n_tiles
    if case == "outliers":
        assert bool((want[-12:] == cap).all()) and float(want[:-12].max()) < cap
    if case == "k_above":
        assert bool((want == cap).all())


@pytest.mark.parametrize("subset", [False, True])
def test_emulated_moments_sweep_matches_plain(rng, subset):
    """The moments kernel's skip, emulated: counts exact and each moment
    within 1e-5 of the sum of |feature| (``plain_disagreement``), per-query
    radii from the prepass; the sweep leaves a fraction of the pairs."""
    n = 2600
    pts = _scan_like(rng, n)
    mask = torch.from_numpy(rng.uniform(size=n) > 0.05)
    q = pts[torch.from_numpy(rng.choice(n, 700, replace=False))].contiguous() if subset else pts
    layout = tcn.normals_layout(q, pts, mask)
    r_pp = tcn.hybrid_radius(3.0, tcn.kth_neighbor_d2_within(q, pts, mask, 20, 3.0, layout))
    got, swept = _emulate_moments(q, pts, mask, r_pp, layout)
    dis = tcn.plain_disagreement(got, *tcn.moment_inputs(q, pts, mask, r_pp))
    assert dis["count_equal"] and dis["moments"] <= 1e-5, dis
    assert dis["neighbours"] >= 20 * int(mask.sum()) * q.shape[0] // n // 2
    sweep = nn_layout.SweepLayout(layout.target, layout.query_order)
    need = nn_layout.tile_need(q[None], torch.ones(q.shape[0], 1), sweep, r_pp ** 2)
    assert swept == int(need.sum()) < 0.7 * need.numel()


def test_per_query_tile_need_drops_no_neighbour(rng):
    """With one r^2 per query, a group's threshold is the largest of its
    valid queries': every (query, support point) pair in a dropped (group,
    tile) lies farther than that query's own r^2."""
    tgt, tvalid = _lattice(rng)
    q, qv = _queries(rng, tgt, 300)
    lay = nn_layout.target_layout(tgt, tvalid)
    order = nn_layout.query_order(q, qv)
    r2 = torch.from_numpy(rng.uniform(0.01, 1.0, 300).astype(np.float32))
    need = nn_layout.tile_need(q[None], qv.to(_F32)[:, None],
                               nn_layout.SweepLayout(lay, order), r2)[0]
    xyz, gidx = _decode(lay)
    n_drop = 0
    for g, qi in enumerate(_groups(nn_layout.SweepLayout(lay, order))):
        qi = qi[qv[qi]]
        for t in torch.nonzero(~need[g])[:, 0].tolist():
            v = xyz[t * 64:(t + 1) * 64]
            d = ((q[qi, None, 0] - v[None, :, 0]) ** 2 + (q[qi, None, 1] - v[None, :, 1]) ** 2
                 + (q[qi, None, 2] - v[None, :, 2]) ** 2)
            assert bool((d > r2[qi][:, None]).all())
            n_drop += 1
    assert 0 < n_drop < need.numel()
    # One threshold for all gives the same as a per-query one of that value.
    same = nn_layout.tile_need(q[None], qv.to(_F32)[:, None], nn_layout.SweepLayout(lay, order),
                               torch.full((300,), 0.09))
    assert torch.equal(same, nn_layout.tile_need(
        q[None], qv.to(_F32)[:, None], nn_layout.SweepLayout(lay, order),
        torch.full((1, 1), 0.09)))


def test_normals_layout_orders_queries_and_is_bound_to_its_call(rng):
    pts = _scan_like(rng, 700)
    mask = torch.from_numpy(rng.uniform(size=700) > 0.1)
    own = tcn.normals_layout(pts, pts, mask)
    assert own.query_order is own.target.order
    q = pts[:300].clone()
    qmask = torch.from_numpy(rng.uniform(size=300) > 0.2)
    at = tcn.normals_layout(q, pts, mask, qmask)
    assert torch.equal(at.query_order, nn_layout.query_order(q, qmask))
    assert torch.equal(own.centroid, tcn.support_centroid(pts, mask)[0])
    tcn.check_layout(at, q, pts, mask)
    for args in ((q.clone(), pts, mask), (q, pts.clone(), mask), (q, pts, mask.clone())):
        with pytest.raises(ValueError):
            tcn.check_layout(at, *args)
        with pytest.raises(ValueError):
            tcn.kth_neighbor_d2_within(*args, 10, 1.0, at)
    q[0, 0] += 1.0
    with pytest.raises(ValueError):
        tcn.radius_moments_at(q, pts, mask, 1.0, at)


def test_normals_layout_costs_few_torch_operations(rng):
    """Per normals call: the centroid (6 operations), the support's target
    layout (21 for a whole number of tiles) and, for queries other than the
    support, their order (12)."""
    pts = _scan_like(rng, 640)
    mask = torch.ones(640, dtype=torch.bool)
    q = pts[:256].clone()
    tcn.normals_layout(pts, pts, mask)
    assert len(_torch_ops(lambda: tcn.normals_layout(pts, pts, mask))) <= 27
    assert len(_torch_ops(lambda: tcn.normals_layout(q, pts, mask, mask[:256]))) <= 39
