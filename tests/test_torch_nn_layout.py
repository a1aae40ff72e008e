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
