"""Kernels K1, K2, K3 and K4 on the card against their plain PyTorch versions
on the same card tensors, at the layouts the JAX signatures allow: one shared
2-D target or one target per batch element, with and without the tile skip,
sizes that do not fill the last block or tile; for K3 and K4 also every
target masked and exact ties.  K1 and K4 share one sweep (``nn_sweep.cuh``):
both run with the layout their wrapper makes and with the main path's (one
query order per batch element, or one for the whole batch), at the B = 1
tracking shapes, with exact ties between targets in different Morton tiles,
every target masked and every tile skipped; two calls on the same inputs
are bit-equal, one call is two kernel launches, and a query order that
leaves out a valid query gives a NaN inlier count.

Marked ``cuda``: they skip without a CUDA card and ``nvcc``.  This file
imports neither JAX nor the JAX package, so it runs on a card's machine that
has no JAX, without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_on_card.py

A 1-rank NCCL group (the card's configuration of ``parallel/``) runs the
block-sharded point-to-plane and GICP loops and a data-sharded batch, each
bit-equal to the call without the group.

K3 runs gated (``nn_argmin_within``, the callers' entry) at the closure
and global-localization shapes and a ragged one, on sensor-range scenes
made to break a skip that is not exact (targets at r (1 +- 2^-20) from a
query, tiles of one point just past the gate, negative expansion d2), with
ties, every target or every query masked; one call is two launches.

The scan preprocess chain (``odometry.preprocess_chain``) replays one CUDA
graph per key: bit for bit the eager chain's clouds on both of the VLP-16
configuration's keys, K2's four kernels in one call's graph, and two keys
captured by a short replay whose poses equal the eager replay's.

Counts (inliers, neighbours) are exact: kernel and plain version test the
same term-by-term rounded float32 distances.  Float sums are summed in
another order, so each entry is held at its own scale (see
``plain_disagreement`` in each kernel module): a Gram entry (i, j) to 1e-5
of sqrt(|G_ii| |G_jj|), the inlier d2 sum to 1e-5 of itself, a moment to
1e-5 of the sum of |feature| over the same neighbours.  1e-5 is about a
hundred float32 roundings of the entry's scale (K4 is held like K1).  K3
computes each distance with the plain version's operations in its order, so
its indices and distances are equal, not close.
"""
import numpy as np
import pytest
import torch

from open3d_slam_torch.ops import cuda_build, cuda_gicp as tg, cuda_icp as ti
from open3d_slam_torch.ops import cuda_knn as tk, gn_graph, hashgrid, nn_layout
from open3d_slam_torch.ops import cuda_normals as tcn
from open3d_slam_torch.ops import normals as tn
from open3d_slam_torch.utils import pointcloud as tpc


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def cuda_device():
    from open3d_slam_torch.utils.device import nvcc_path
    if not torch.cuda.is_available() or nvcc_path() is None:
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _planes(rng, n, noise=0.02, scale=4.0):
    """Ground and wall planes, spatially sorted (the packed-voxel order the
    main path hands the kernels keeps tiles compact)."""
    half = n // 2
    ground = np.stack([rng.uniform(-4, 4, half), rng.uniform(-4, 4, half),
                       np.zeros(half)], axis=1)
    wall = np.stack([np.full(n - half, 2.0), rng.uniform(-4, 4, n - half),
                     rng.uniform(0, 3, n - half)], axis=1)
    pts = (np.concatenate([ground, wall]) + rng.normal(scale=noise, size=(n, 3))) * scale
    return pts[np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))].astype(np.float32)


def _cloud_with_covs(pts, mask, dev):
    pc = tpc.PointCloud(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
    pc = tn.estimate_normals(pc, 1.0, max_nn=12)
    return pc.points, pc.mask, tn.covariances_from_normals(pc)


def _gicp_problem(rng, dev, batch, m, n, shared_target):
    """Sources near the target(s), some rows invalid, some padding."""
    tgts, srcs = [], []
    for b in range(1 if shared_target else batch):
        pts = _planes(rng, n)
        mask = np.ones(n, bool)
        mask[-(n // 50):] = False
        tgts.append(_cloud_with_covs(pts, mask, dev))
    for b in range(batch):
        base = tgts[0 if shared_target else b][0].cpu().numpy()
        pts = base[rng.choice(n, m, replace=False)] + rng.normal(
            scale=0.05, size=(m, 3)).astype(np.float32)
        mask = rng.uniform(size=m) > 0.05
        srcs.append(_cloud_with_covs(pts, mask, dev))
    tp, tm, tc = (torch.stack(a) for a in zip(*tgts))
    if shared_target:
        tp, tm, tc = tp[0], tm[0], tc[0]
    td, tv, t_lay = tg.prepare_target(tp, tc, tm)
    q = torch.stack([p for p, _, _ in srcs]).contiguous()
    qc = torch.stack([tg.cov6_from_full(c) for _, _, c in srcs]).contiguous()
    qm = torch.stack([v.to(torch.float32)[:, None] for _, v, _ in srcs])
    if shared_target and batch == 1:
        qm = qm[0]
    r2 = torch.full((1, 1), 0.25, device=dev)
    return (q, qm.contiguous(), qc, td, tv, r2), t_lay


def _layouts(q, qm, t_lay):
    """None (the wrapper makes its own), and the main path's: the target's
    from ``prepare_target`` with the sources' Morton order, one per batch
    element, or element 0's for the whole batch."""
    b, m, _ = q.shape
    qv = (qm.reshape(-1, m) > 0).expand(b, m)
    return [None, nn_layout.SweepLayout(t_lay, nn_layout.query_order(q, qv)),
            nn_layout.SweepLayout(t_lay, nn_layout.query_order(q[0], qv[0]))]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n,shared", [
    (1, 4096, 16384, True),     # one shared target, with the tile skip
    (3, 1000, 3000, False),     # a target per element; partial block/tile
    (2, 640, 2048, True),       # a shared target across a batch
    (1, 16384, 16384, True),    # odometry
    (1, 4096, 65536, True),     # scan-to-map
])
def test_gicp_kernel_matches_plain_on_card(cuda_device, rng, batch, m, n, shared):
    """With the layout the wrapper makes from its inputs, and with the
    main path's (``_layouts``); two launches on the same inputs are
    bit-equal."""
    args, t_lay = _gicp_problem(rng, cuda_device, batch, m, n, shared)
    want = tg.gicp_normal_eq_plain(*args)
    for lay in _layouts(args[0], args[1], t_lay):
        before = cuda_build.launches[("gicp_normal_eq", (batch, m, n))]
        got = tg.gicp_normal_eq(*args, None, lay)
        assert cuda_build.launches[("gicp_normal_eq", (batch, m, n))] == before + 1
        assert got.shape == (batch, 8, 128)
        assert float(want[:, 7, 0].min()) > 0.5 * m
        dis = tg.plain_disagreement(got, want)
        assert dis["n_in_equal"] and dis["rest_equal"], dis
        assert dis["gram"] <= 1e-5 and dis["d2s"] <= 1e-5, dis
        assert torch.equal(got, tg.gicp_normal_eq(*args, None, lay))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,per_query", [(4096, 16384, True), (1000, 3001, False)])
def test_radius_moments_kernel_matches_plain_on_card(cuda_device, rng, m, n, per_query):
    pts = torch.from_numpy(_planes(rng, n)).to(cuda_device)
    mask = torch.from_numpy(rng.uniform(size=n) > 0.02).to(cuda_device)
    q = pts[torch.from_numpy(rng.choice(n, m, replace=False)).to(cuda_device)]
    radius = (tcn.hybrid_radius(3.0, tcn.kth_neighbor_d2_at(q, pts, mask, 20))
              if per_query else 0.7)
    before = cuda_build.launches[("radius_moments_at", (m, n))]
    got = tcn.radius_moments_at(q, pts, mask, radius)
    assert cuda_build.launches[("radius_moments_at", (m, n))] == before + 1
    dis = tcn.plain_disagreement(got, *tcn.moment_inputs(q, pts, mask, radius))
    assert dis["count_equal"], dis
    assert dis["neighbours"] > 2 * m
    assert dis["moments"] <= 1e-5, dis


def _prepass_problem(rng, dev, m, n, case):
    """(queries, support, mask, k) of one prepass case on the card."""
    pts = _planes(rng, n)
    mask = rng.uniform(size=n) > 0.02
    k = 20
    if case == "all_masked":
        mask[:] = False
    if case == "k_above_count":       # 12 valid points, k = 20: r^2 everywhere
        mask[:] = False
        mask[rng.choice(n, 12, replace=False)] = True
    if case == "duplicates":          # every point three times: exact ties
        pts = np.concatenate([pts[: n // 3]] * 3 + [pts[: n - 3 * (n // 3)]])
    if case == "far_group":           # 10 points 500 m off: fewer than k within r
        pts[-10:] += np.float32([500.0, 0.0, 0.0])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)   # noqa: E731
    pts_t, mask_t = t(pts), t(mask)
    if m == n:
        return pts_t, pts_t, mask_t, k
    return pts_t[t(rng.choice(n, m, replace=False))].contiguous(), pts_t, mask_t, k


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,case", [
    (4096, 16384, "mapper"),          # the mapper's queries against its support
    (16384, 16384, "self"),           # odometry: a cloud against itself
    (1000, 3001, "ragged"),           # partial group and tile
    (1000, 3001, "all_masked"),
    (1000, 3001, "k_above_count"),
    (3001, 3001, "duplicates"),
    (3001, 3001, "far_group"),
])
def test_kth_prepass_kernel_equals_plain_on_card(cuda_device, rng, m, n, case):
    """The prepass kernel is bit-equal to its plain version (the k-th
    smallest of a multiset does not depend on the visiting order or the
    splits), with the layout the wrapper makes and with the normals path's;
    one call is one counted launch: the sweep, and the merge of the splits
    where there are several."""
    q, pts, mask, k = _prepass_problem(rng, cuda_device, m, n, case)
    cap = float(torch.tensor(3.0) ** 2)
    want = tcn.kth_neighbor_d2_within_plain(q, pts, mask, k, cap)
    key = ("kth_neighbor_d2_within", (m, n))
    for layout in (None, tcn.normals_layout(q, pts, mask)):
        before = cuda_build.launches[key]
        got = tcn.kth_neighbor_d2_within(q, pts, mask, k, 3.0, layout)
        assert cuda_build.launches[key] == before + 1
        assert torch.equal(got, want), float((got - want).abs().max())
    if case in ("all_masked", "k_above_count"):
        assert bool((want == cap).all())
    else:
        assert float((want < cap).float().mean()) > 0.5
    if case == "far_group":
        assert bool((want[-10:] == cap).all())
    layout = tcn.normals_layout(q, pts, mask)
    names, again = gn_graph.graph_nodes(
        lambda: tcn.kth_neighbor_d2_within(q, pts, mask, k, 3.0, layout), cuda_device)
    splits = tcn.plan_splits(m, layout.target.boxes.shape[0], cuda_device,
                             tcn._KTH_MAX_SPLITS)
    assert len(names) == (1 if splits == 1 else 2) and "kth_sweep" in names[0], names
    assert splits == 1 or "kth_merge" in names[1], names
    assert torch.equal(again, want)


@pytest.mark.cuda
def test_kth_prepass_kernel_refuses_k_above_its_maximum(cuda_device, rng):
    q, pts, mask, _ = _prepass_problem(rng, cuda_device, 1000, 3001, "ragged")
    assert tcn.KTH_MAX_K == 32
    tcn.kth_neighbor_d2_within(q, pts, mask, 32, 3.0)
    with pytest.raises(ValueError):
        tcn.kth_neighbor_d2_within(q, pts, mask, 33, 3.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(16384, 16384), (4096, 16384), (1000, 3001)])
def test_moments_kernel_with_varied_radii_on_card(cuda_device, rng, m, n):
    """Per-query radii from 0.05 m to 3 m, with the normals path's layout:
    counts exact, each moment within 1e-5 of the sum of |feature|; two
    calls bit-equal."""
    pts = torch.from_numpy(_planes(rng, n)).to(cuda_device)
    mask = torch.from_numpy(rng.uniform(size=n) > 0.02).to(cuda_device)
    q = pts if m == n else pts[torch.from_numpy(rng.choice(n, m, replace=False)).to(
        cuda_device)].contiguous()
    radius = torch.from_numpy(np.exp(rng.uniform(np.log(0.05), np.log(3.0), m)).astype(
        np.float32)).to(cuda_device)
    layout = tcn.normals_layout(q, pts, mask)
    got = tcn.radius_moments_at(q, pts, mask, radius, layout)
    dis = tcn.plain_disagreement(got, *tcn.moment_inputs(q, pts, mask, radius))
    assert dis["count_equal"], dis
    assert dis["moments"] <= 1e-5, dis
    assert dis["neighbours"] > 2 * m
    assert torch.equal(got, tcn.radius_moments_at(q, pts, mask, radius, layout))


def _knn_on_card(q, t, t2):
    """K3 and its plain version on the same card tensors; the launch is
    counted once."""
    key = ("nn_argmin", (q.shape[0], t.shape[1]))
    before = cuda_build.launches[key]
    got = tk.nn_argmin(q, t, t2)
    assert cuda_build.launches[key] == before + 1
    want = tk.nn_argmin_plain(*tk.knn_inputs(q, t, t2))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(4096, 16384), (1000, 3001), (32768, 65536)])
def test_nn_argmin_kernel_matches_plain_on_card(cuda_device, rng, m, n):
    """Random clouds with a fifth of the targets masked; the middle case
    fills neither the last query block nor the last target tile."""
    t = torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(rng.uniform(-20, 20, (m, 3)).astype(np.float32)).to(cuda_device)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.2).to(cuda_device)
    t2 = torch.where(valid, tk.squared_norms(t), torch.full((), float("inf"), device=cuda_device))
    (gi, gd), (wi, wd) = _knn_on_card(q, t.t().contiguous(), t2)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert bool(valid[gi.long()].all())


@pytest.mark.cuda
def test_nn_argmin_kernel_all_masked_on_card(cuda_device, rng):
    t = torch.from_numpy(rng.uniform(-5, 5, (777, 3)).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(rng.uniform(-5, 5, (300, 3)).astype(np.float32)).to(cuda_device)
    t2 = torch.full((777,), float("inf"), device=cuda_device)
    (gi, gd), (wi, wd) = _knn_on_card(q, t.t().contiguous(), t2)
    assert int(gi.abs().max()) == 0 and bool(torch.isinf(gd).all())
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.cuda
def test_nn_argmin_kernel_breaks_ties_to_lowest_index_on_card(cuda_device):
    """Every target repeated at three indices, the copies in different
    tiles and splits: the lowest index wins, as in the Pallas kernel."""
    base = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0],
                         [0.0, 0.0, 3.0]], device=cuda_device)
    t = torch.cat([base.repeat(700, 1), base.repeat(700, 1) + 100.0, base.repeat(700, 1)])
    q = torch.tensor([[0.1, 0.0, 0.0], [2.9, 0.1, 0.0], [0.0, 2.8, 0.1],
                      [0.0, 0.2, 2.9]], device=cuda_device).repeat(50, 1)
    t2 = tk.squared_norms(t)
    (gi, gd), (wi, wd) = _knn_on_card(q, t.t().contiguous(), t2)
    assert gi[:4].tolist() == [0, 1, 2, 3]
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def _sensor_scene(rng, n, lo=30.0, hi=80.0):
    """Wall patches 30-80 m from the origin (the expansion form rounds by
    ~1e-3 m^2 there), in index order as a sensor returns them."""
    walls = []
    for _ in range(8):
        az, rad = rng.uniform(0, 2 * np.pi), rng.uniform(lo, hi)
        c = np.array([rad * np.cos(az), rad * np.sin(az), rng.uniform(-2, 2)])
        s = rng.uniform(-3, 3, (n // 8, 2))
        walls.append(c + s[:, :1] * np.array([-np.sin(az), np.cos(az), 0.0])
                     + s[:, 1:] * np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.01, (n // 8, 3)))
    return np.concatenate(walls).astype(np.float32)


def _knn_layout(pts, valid, queries, qmask):
    """K3's target layout of (pts, valid) and the Morton order of the first
    pose's queries, on the queries' card."""
    dev = queries.device
    target = nn_layout.target_layout(torch.from_numpy(pts).to(dev),
                                     torch.from_numpy(valid).to(dev))
    qv = (torch.ones(queries.shape[1], dtype=torch.bool, device=dev) if qmask is None
          else qmask.reshape(-1, queries.shape[1])[0])
    return nn_layout.SweepLayout(target, nn_layout.query_order(queries[0], qv))


def _knn_gated_on_card(queries, qmask, layout, r):
    """``nn_argmin_within`` against the full plain sweep on the same card
    tensors: the callers' verdict (winner's exact d2 within r, a valid
    target) equal, the index and e bit-equal wherever it holds, (0, +inf)
    or a rejected winner elsewhere; one counted launch.  Returns the full
    sweep's (found, e)."""
    b, m, _ = queries.shape
    key = ("nn_argmin_within", (b, m, layout.target.order.shape[-1]))
    before = cuda_build.launches[key]
    gi, ge = tk.nn_argmin_within(queries, qmask, layout, r)
    assert cuda_build.launches[key] == before + 1
    assert gi.dtype == torch.int32 and ge.dtype == torch.float32 and gi.shape == (b, m)
    wi, we = tk.nn_argmin_within_plain(queries, qmask, layout)
    points, valid = tk.layout_targets(layout.target)
    r2 = torch.tensor(float(r), dtype=torch.float32, device=queries.device) ** 2
    (gf, gd2), (wf, _) = (hashgrid.gate(points, valid, queries, i, e, r)
                          for i, e in ((gi, ge), (wi, we)))
    assert torch.equal(gf, wf)
    assert torch.equal(gi[wf], wi[wf])
    assert torch.equal(ge[wf].view(torch.int32), we[wf].view(torch.int32))
    rest = ~wf
    assert bool((((ge[rest] == float("inf")) & (gi[rest] == 0)) | (gd2[rest] > r2)).all())
    return wf, we


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,r", [(1, 32768, 65536, 0.3), (1, 1000, 3001, 0.3),
                                     (64, 1024, 16384, 2.0)])
def test_nn_argmin_within_matches_full_sweep_on_card(cuda_device, rng, b, m, n, r):
    """The closure shape at 0.3 m and the global-localization mid stage's
    (64 poses of one 1024-point source at 2.0 m, one shared order), and a
    ragged size; a sensor-range scene with an invalid block (whole invalid
    tiles) and a partial last tile; sources scattered up to 2r off targets,
    within millimetres of them (negative e) and at r (1 +- 2^-20)."""
    pts = _sensor_scene(rng, n // 8 * 8 + 8)[:n]
    valid = np.ones(n, bool)
    valid[-(n // 5):] = False
    base = pts[rng.choice(np.flatnonzero(valid), m)]
    k = m // 3
    u = rng.normal(size=(m - 2 * k, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    src = np.concatenate([
        base[:k] + rng.normal(0, r, (k, 3)),
        base[k:2 * k] + rng.uniform(-3e-3, 3e-3, (k, 3)),
        base[2 * k:] + r * (1 + rng.choice([-1, 1], (m - 2 * k, 1)) * 2.0 ** -20) * u,
    ]).astype(np.float32)
    yaw = np.linspace(0.0, 0.02, b, dtype=np.float32)
    poses = np.stack([src @ np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                                      [0, 0, 1]], np.float32).T + np.float32(0.01 * i)
                      for i, a in enumerate(yaw)]).astype(np.float32)
    queries = torch.from_numpy(poses).to(cuda_device)
    qmask = torch.from_numpy(rng.uniform(size=m) > 0.05).to(cuda_device)
    layout = _knn_layout(pts, valid, queries, qmask)
    found, e = _knn_gated_on_card(queries, qmask, layout, r)
    assert 0.2 < float(found.float().mean()) < 0.97
    assert bool((e < 0).any())
    # Ungated on the same inputs: bit-equal to the plain version.
    q = queries.reshape(-1, 3)
    points, tvalid = tk.layout_targets(layout.target)
    t2 = torch.where(tvalid, tk.squared_norms(points), float("inf"))
    (gi, gd), (wi, wd) = _knn_on_card(q, points.t().contiguous(), t2)
    assert torch.equal(gi, wi) and torch.equal(gd.view(torch.int32), wd.view(torch.int32))


@pytest.mark.cuda
def test_nn_argmin_within_ties_masks_and_gate_edges_on_card(cuda_device):
    """Tiles of one duplicated point each, just past and just inside the
    gate at 80 m (the winner in e is often the one past it); exact ties to
    the lower index across tiles; every target masked; every query
    masked."""
    rng = np.random.default_rng(3)
    r, probes = 0.3, 96
    qs, tv, tw = [], [], []
    for p in range(probes):
        az = 2 * np.pi * p / probes
        Q = np.array([80 * np.cos(az), 80 * np.sin(az), 1.0])
        u, w = rng.normal(size=(2, 3))
        qs.append(np.repeat(Q[None], 64, 0))
        tv.append(np.repeat((Q + r * (1 - 2.0 ** -12) * u / np.linalg.norm(u))[None], 128, 0))
        tw.append(np.repeat((Q + r * (1 + 2.0 ** -12) * w / np.linalg.norm(w))[None], 128, 0))
    pts = np.concatenate(tw + tv).astype(np.float32)
    queries = torch.from_numpy(np.concatenate(qs).astype(np.float32))[None].to(cuda_device)
    valid = np.ones(len(pts), bool)
    layout = _knn_layout(pts, valid, queries, None)
    found, _ = _knn_gated_on_card(queries, None, layout, r)
    assert 0 < int(found.sum()) < found.numel()
    gi, _ = tk.nn_argmin_within(queries, None, layout, r)
    assert bool((gi[found] % 128 == 0).all())          # the first copy of each run
    for name, lay, qmask in (
            ("all_masked", _knn_layout(pts, ~valid, queries, None), None),
            ("no_query", layout, torch.zeros(queries.shape[1], dtype=torch.bool,
                                             device=cuda_device))):
        gi, ge = tk.nn_argmin_within(queries, qmask, lay, r)
        assert int(gi.abs().max()) == 0 and bool(torch.isinf(ge).all()), name
        _knn_gated_on_card(queries, qmask, lay, r)


@pytest.mark.cuda
def test_nn_argmin_within_is_two_kernel_launches_on_card(cuda_device, rng):
    """One call launches the sweep and the decode and nothing else; two
    calls on the same inputs are bit-equal (the decode leaves the keys all
    ones)."""
    pts = _sensor_scene(rng, 4096)
    queries = torch.from_numpy(pts[rng.choice(4096, 1024)] + np.float32(0.05))[None]
    queries = queries.contiguous().to(cuda_device)
    layout = _knn_layout(pts, np.ones(4096, bool), queries, None)
    first = tk.nn_argmin_within(queries, None, layout, 0.3)
    names, again = gn_graph.graph_nodes(lambda: tk.nn_argmin_within(queries, None, layout, 0.3),
                                        cuda_device)
    assert len(names) == 2, names
    assert "knn_sweep" in names[0] and "knn_decode" in names[1], names
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def _p2l_problem(rng, dev, batch, m, n, shared):
    """Posed copies of a subsample near planar target(s) with normals, a
    twentieth of the sources invalid, the last fiftieth of each target
    padding; the shared case also shares the (M, 1) mask."""
    tgts = []
    for _ in range(1 if shared else batch):
        pts = _planes(rng, n)
        mask = np.ones(n, bool)
        mask[-(n // 50):] = False
        pc = tpc.PointCloud(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
        tgts.append(tn.estimate_normals(pc, 1.0, max_nn=12))
    tp, tnrm, tm = (torch.stack(a) for a in zip(*((t.points, t.normals, t.mask)
                                                    for t in tgts)))
    if shared:
        tp, tnrm, tm = tp[0], tnrm[0], tm[0]
    *target, t_lay = ti.prepare_target(tp, tnrm, tm)
    srcs = []
    for b in range(batch):
        base = tgts[0 if shared else b].points.cpu().numpy()
        srcs.append(base[rng.choice(n, m, replace=m > n)] +
                    rng.normal(scale=0.05, size=(m, 3)).astype(np.float32))
    q = torch.from_numpy(np.stack(srcs)).to(dev).contiguous()
    qm = torch.from_numpy((rng.uniform(size=(batch, m, 1)) > 0.05).astype(np.float32)).to(dev)
    qm = (qm[0] if shared else qm).contiguous()
    return (q, qm, *target, torch.full((1, 1), 0.25, device=dev)), t_lay


def _p2l_on_card(args):
    """K4 and its plain version on the same card tensors; the launch is
    counted once."""
    key = ("p2l_normal_eq", (args[0].shape[0], args[0].shape[1], args[2].shape[-1]))
    before = cuda_build.launches[key]
    got = ti.p2l_normal_eq(*args)
    assert cuda_build.launches[key] == before + 1
    want = ti.p2l_normal_eq_plain(*args[:7])
    assert got.shape == want.shape == (args[0].shape[0], 8, 128)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n,shared", [
    (1, 16384, 16384, True),    # odometry
    (1, 4096, 65536, True),     # scan-to-map
    (1, 8192, 32768, True),     # the final registration: B = 1, target split
    (1, 32768, 65536, True),    # the refinement of an odometry constraint
    (64, 2048, 8192, True),     # a hypothesis batch against one map
    (3, 1000, 3001, False),     # a target per element; partial block/tile
])
def test_p2l_kernel_matches_plain_on_card(cuda_device, rng, batch, m, n, shared):
    """With the layout the wrapper makes from its inputs, and with the
    main path's (``_layouts``); two launches on the same inputs are
    bit-equal."""
    args, t_lay = _p2l_problem(rng, cuda_device, batch, m, n, shared)
    for lay in _layouts(args[0], args[1], t_lay):
        got, want = _p2l_on_card(args + (lay,))
        assert float(want[:, 7, 0].min()) > 0.5 * m
        dis = ti.plain_disagreement(got, want)
        assert dis["n_in_equal"] and dis["rest_equal"], dis
        assert dis["gram"] <= 1e-5 and dis["d2s"] <= 1e-5, dis
        assert torch.equal(got, ti.p2l_normal_eq(*args, lay))


@pytest.mark.cuda
def test_p2l_kernel_all_targets_masked_on_card(cuda_device, rng):
    args = list(_p2l_problem(rng, cuda_device, 2, 300, 777, True)[0])
    args[5] = torch.zeros_like(args[5])
    args[6] = torch.full((1, 1), 1e30, device=cuda_device)
    got, want = _p2l_on_card(tuple(args))
    assert not bool(got.any()) and not bool(want.any())


@pytest.mark.cuda
def test_p2l_kernel_breaks_ties_to_lowest_index_on_card(cuda_device):
    """Every target at three indices in other tiles and splits, the later
    copies with other normals: the Gram is that of the first copy's
    normal (+z) for every inlier."""
    base = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0],
                         [0.0, 0.0, 3.0]], device=cuda_device)
    pts = torch.cat([base.repeat(700, 1), base.repeat(700, 1) + 100.0, base.repeat(700, 1)])
    nrm = torch.zeros_like(pts)
    nrm[:2800, 2] = 1.0
    nrm[2800:, 0] = 1.0
    q = (base.repeat(50, 1) + 0.01)[None].contiguous()
    target = ti.prepare_target(pts, nrm, torch.ones(pts.shape[0], dtype=torch.bool,
                                                    device=cuda_device))[:4]
    args = (q, torch.ones((200, 1), device=cuda_device)) + target + (
        torch.full((1, 1), 0.04, device=cuda_device),)
    got, want = _p2l_on_card(args)
    dis = ti.plain_disagreement(got, want)
    assert dis["n_in_equal"] and dis["gram"] <= 1e-5, dis
    assert float(got[0, 3, 3]) == 0.0 and float(got[0, 5, 5]) == 200.0


def _lattice_ties(dev, m, seed=5):
    """16384 targets on a 0.5 m lattice in a random index order, each with
    its own normal and covariance, and m sources a quarter step off targets
    in x: two lattice neighbours at d2 = 0.0625 exactly, the lower index
    the winner wherever the two fall in Morton order (about half the time
    it comes later, in another tile)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(32), np.arange(32), np.arange(16),
                             indexing="ij"), -1).reshape(-1, 3) * 0.5
    pts = g[rng.permutation(len(g))].astype(np.float32)
    q = pts[rng.choice(len(pts), m, replace=False)] + np.float32([0.25, 0.0, 0.0])
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = rng.normal(size=pts.shape).astype(np.float32)
    covs = 0.01 * np.eye(3, dtype=np.float32) + 0.001 * a[:, :, None] * a[:, None, :]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)   # noqa: E731
    return t(pts), t(nrm), t(covs), t(q)


def _sweep_cases(dev, kernel, m=4096):
    """(name, args, layout) of K1 or K4 on the lattice: the ties, every
    target masked, and every tile skipped (the sources 100 m off the map)."""
    pts, nrm, covs, q = _lattice_ties(dev, m)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    qm = torch.ones((m, 1), device=dev)
    r2 = torch.full((1, 1), 0.09, device=dev)
    far = q + torch.tensor([100.0, 0.0, 0.0], device=dev)
    cases = []
    for name, src, tvalid in (("ties", q, valid), ("all_masked", q, ~valid),
                              ("all_skipped", far, valid)):
        if kernel == "p2l":
            *target, t_lay = ti.prepare_target(pts, nrm, tvalid)
            args = (src[None].contiguous(), qm, *target, r2)
        else:
            td, tv, t_lay = tg.prepare_target(pts, covs, tvalid)
            qc = tg.cov6_from_full(covs[:m])[None].contiguous()
            args = (src[None].contiguous(), qm, qc, td, tv, r2)
        order = nn_layout.query_order(q, torch.ones(m, dtype=torch.bool, device=dev))
        cases.append((name, args, nn_layout.SweepLayout(t_lay, order)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["p2l", "gicp"])
def test_sweep_ties_masks_and_skips_on_card(cuda_device, kernel):
    """Exact ties across Morton tiles go to the lower index (each target
    has its own normal or covariance, so a wrong winner moves the Gram);
    every target masked, or every tile skipped, gives zeros."""
    mod = ti if kernel == "p2l" else tg
    for name, args, layout in _sweep_cases(cuda_device, kernel):
        want = (ti.p2l_normal_eq_plain(*args) if kernel == "p2l"
                else tg.gicp_normal_eq_plain(*args))
        got = (ti.p2l_normal_eq(*args, layout) if kernel == "p2l"
               else tg.gicp_normal_eq(*args, None, layout))
        dis = mod.plain_disagreement(got, want)
        assert dis["n_in_equal"] and dis["rest_equal"], (name, dis)
        assert dis["gram"] <= 1e-5 and dis["d2s"] <= 1e-5, (name, dis)
        if name == "ties":
            assert float(got[0, 7, 0]) == 4096.0
            assert float(got[0, 7, 1]) == 0.0625 * 4096
        else:
            assert not bool(got.any()) and not bool(want.any()), name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["p2l", "gicp"])
def test_one_call_is_two_kernel_launches_on_card(cuda_device, kernel):
    """With the layout given, a wrapper call launches the sweep and the row
    kernel and nothing else (the last row block writes the whole output)."""
    _, args, layout = _sweep_cases(cuda_device, kernel, m=1024)[0]
    call = ((lambda: ti.p2l_normal_eq(*args, layout)) if kernel == "p2l"
            else (lambda: tg.gicp_normal_eq(*args, None, layout)))
    first = call()
    names, again = gn_graph.graph_nodes(call, cuda_device)
    assert len(names) == 2, names
    assert "nn_sweep" in names[0] and "_rows" in names[1], names
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["p2l", "gicp"])
def test_query_order_that_leaves_out_a_query_is_marked_on_card(cuda_device, kernel):
    """A query order that names one query twice and so leaves a valid one
    out, or names one outside [0, M), gives a NaN inlier count instead of a
    silent outlier; the next call with the whole order is exact again."""
    _, args, layout = _sweep_cases(cuda_device, kernel, m=1024)[0]
    call = ((lambda lay: ti.p2l_normal_eq(*args, lay)) if kernel == "p2l"
            else (lambda lay: tg.gicp_normal_eq(*args, None, lay)))
    good = call(layout)
    twice, outside = layout.query_order.clone(), layout.query_order.clone()
    twice[5] = twice[6]
    outside[5] = 1 << 20
    for order in (twice, outside):
        out = call(layout._replace(query_order=order))
        assert bool(torch.isnan(out[0, 7, 0])) and not bool(torch.isnan(out[0, 7, 1]))
        assert torch.equal(call(layout), good)


@pytest.mark.cuda
def test_one_rank_nccl_group_is_bit_equal_to_no_group_on_card(cuda_device, rng):
    """The card's configuration of the scale-out layer, a 1-rank NCCL
    group: block-sharded point-to-plane (K4) and GICP (K1) and a
    data-sharded batch of 4 registrations (K4, a target per element) give
    exactly what the calls without the group give, and the batch's first
    two elements alone what they give in it."""
    import torch.distributed as dist
    from open3d_slam_torch.ops import registration as treg
    from open3d_slam_torch.parallel import mesh as mesh_lib, multihost, sharded_icp

    def same(a, b):
        return all(torch.equal(getattr(a, k), getattr(b, k)) for k in
                   ("transformation", "fitness", "inlier_rmse", "num_iterations"))

    def cloud(pts):
        return tpc.PointCloud(torch.from_numpy(pts).to(cuda_device),
                              torch.ones(len(pts), dtype=torch.bool, device=cuda_device))

    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, device="cuda",
                         timeout_s=120.0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = multihost.global_mesh(1)
        eye = torch.eye(4, device=cuda_device)
        offset = np.array([0.1, -0.05, 0.02], np.float32)
        pts = _planes(rng, 4096)
        tgt = tn.estimate_normals(cloud(pts), 1.0, max_nn=12)
        grid = hashgrid.build(tgt, 0.8)
        scan = tn.estimate_normals(cloud(pts[rng.choice(4096, 1024, replace=False)] + offset),
                                   1.0, max_nn=12)
        before = dict(cuda_build.launches)
        got = sharded_icp.make_block_sharded_icp(mesh, 0.8, max_iterations=10)(
            sharded_icp.split_points_for_blocks(scan, 1), grid, eye)
        assert same(got, treg.icp_point_to_plane(scan, grid, eye, 0.8, max_iterations=10))
        assert float(got.fitness) > 0.9

        covs = tn.covariances_from_normals(tgt)[grid.order.long()]
        scan_covs = tn.covariances_from_normals(scan)
        got = sharded_icp.make_block_sharded_gicp(mesh, 0.8, max_iterations=10)(
            sharded_icp.split_points_for_blocks(scan, 1),
            sharded_icp.split_points_for_blocks(scan_covs, 1), grid, covs, eye)
        assert same(got, treg.icp_generalized(scan, scan_covs, grid, covs, eye, 0.8,
                                              max_iterations=10))

        tgts = [tn.estimate_normals(cloud(_planes(rng, 2048)), 1.0, max_nn=12) for _ in range(4)]
        grids = hashgrid.build_batched(tpc.PointCloud(
            torch.stack([t.points for t in tgts]), torch.stack([t.mask for t in tgts]),
            torch.stack([t.normals for t in tgts])), 0.8)
        srcs = tpc.PointCloud(
            torch.stack([t.points[torch.from_numpy(rng.choice(2048, 512, replace=False)).to(
                cuda_device)] + torch.from_numpy(offset).to(cuda_device) for t in tgts]),
            torch.ones((4, 512), dtype=torch.bool, device=cuda_device))
        inits = eye.repeat(4, 1, 1)
        got = sharded_icp.batched_icp_p2l(srcs, grids, inits, 0.8, max_iterations=10, mesh=mesh)
        assert same(got, treg.batched_icp_point_to_plane(srcs, grids, inits, 0.8,
                                                         max_iterations=10))
        # Two elements alone, as rank 0 of two runs them (other sweep splits).
        alone = treg.batched_icp_point_to_plane(
            *mesh_lib.map_tensors(lambda x: x[:2], (srcs, grids, inits)), 0.8, max_iterations=10)
        assert same(alone, got[:2])
        assert bool((got.fitness > 0.9).all())
        launched = {k for k, n in cuda_build.launches.items() if n != before.get(k, 0)}
        assert ("p2l_normal_eq", (4, 512, 2048)) in launched
        assert ("gicp_normal_eq", (1, 1024, 4096)) in launched
    finally:
        dist.destroy_process_group()


def _captured(fn, dev):
    """``fn`` run eagerly, then captured into a CUDA graph on a side stream
    (after a warm-up there) and replayed: (eager output, replayed output)."""
    want = fn()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return want, out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4, 128, 1024])
def test_gn_iteration_math_captures_bit_equal_on_card(cuda_device, rng, batch):
    """The small operations of a Gauss-Newton iteration around K1/K4 (the
    jittered 6x6 Cholesky solve, both retractions, the frozen update, the
    point transform and the covariance rotation) capture into a CUDA graph
    and replay to the eager result's bits."""
    from open3d_slam_torch.ops import cuda_gn_step
    from open3d_slam_torch.utils import se3
    A = rng.normal(size=(batch, 6, 12)).astype(np.float32)
    JtJ = torch.from_numpy(A @ A.transpose(0, 2, 1)).to(cuda_device)
    Jtr = torch.from_numpy(rng.normal(size=(batch, 6)).astype(np.float32)).to(cuda_device)
    T = se3.se3_exp(torch.from_numpy(0.1 * rng.normal(size=(batch, 6)).astype(
        np.float32)).to(cuda_device)).contiguous()
    done = torch.from_numpy(rng.uniform(size=batch) < 0.3).to(cuda_device)
    pts = torch.from_numpy(rng.normal(size=(batch, 2048, 3)).astype(np.float32)).to(cuda_device)
    cov6 = torch.from_numpy(rng.normal(size=(batch, 2048, 6)).astype(np.float32)).to(cuda_device)

    def step():
        delta = cuda_gn_step.solve6_chain(JtJ, Jtr)
        outs = [delta]
        for retract in (se3.se3_exp, cuda_gn_step.euler_xyz_transform):
            T_new = torch.where(done[:, None, None], T, retract(delta) @ T)
            outs += [T_new, se3.transform_points(T_new, pts).contiguous(),
                     tg.rotate_cov6(T_new[..., :3, :3], cov6).contiguous()]
        return outs

    want, got = _captured(step, cuda_device)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


def _loop_problem(rng, dev, kind, batch, m, n, max_iterations):
    """A fused GN loop (``registration._icp_gicp_fused_batch`` or
    ``_icp_p2l_fused_batch``) at B = batch, M = m, N = n: one shared target
    at B = 1, else one per element (four distinct ones, tiled), sources
    drawn from their target and moved off it.  Returns ``run()``."""
    from open3d_slam_torch.ops import registration as treg
    from open3d_slam_torch.utils import se3
    kinds = min(batch, 4)
    clouds = []
    for _ in range(kinds):
        pts = _planes(rng, n)
        mask = np.ones(n, bool)
        mask[-(n // 50):] = False
        pc = tn.estimate_normals(tpc.PointCloud(torch.from_numpy(pts).to(dev),
                                                torch.from_numpy(mask).to(dev)), 1.0, max_nn=12)
        clouds.append((pc.points, pc.mask, pc.normals, tn.covariances_from_normals(pc)))
    pick = [clouds[i % kinds] for i in range(batch)]
    tp, tm, tnrm, tcov = (torch.stack(a) for a in zip(*pick))
    valid = int(clouds[0][1].sum())
    src = [c[0][torch.from_numpy(rng.choice(valid, m, replace=m > valid)).to(dev)]
           for c in pick]
    q = (torch.stack(src) + torch.from_numpy(
        rng.normal(scale=0.03, size=(batch, m, 3)).astype(np.float32)).to(dev)).contiguous()
    qv = torch.from_numpy(rng.uniform(size=(batch, m)) > 0.05).to(dev)
    xi = torch.from_numpy(np.concatenate([rng.normal(scale=0.02, size=(batch, 3)),
                                          rng.normal(scale=0.15, size=(batch, 3))], 1)
                          .astype(np.float32)).to(dev)
    inits = se3.se3_exp(xi).contiguous()
    if batch == 1:
        tp, tm, tnrm, tcov, qmask = tp[0], tm[0], tnrm[0], tcov[0], qv[0]
    else:
        qmask = qv
    maskf = qmask.to(torch.float32)[..., None].contiguous()
    n_src = qv.to(torch.float32).sum(-1)
    order = nn_layout.query_order(q if batch > 1 else q[0], qmask)
    if kind == "gicp":
        up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(m, 3)
        qcov6 = torch.stack([tg.cov6_from_full(tn.covariances_from_normals(
            tpc.PointCloud(s, v, up))) for s, v in zip(q, qv)]).contiguous()
        td, tv, t_lay = tg.prepare_target(tp, tcov, tm)
        layout = nn_layout.SweepLayout(t_lay, order)
        return lambda: treg._icp_gicp_fused_batch(q, maskf, n_src, qcov6, td, tv, inits, 0.5,
                                                  max_iterations, 1e-6, 1e-6, layout)
    t_t, tn_t, tc, tv, t_lay = ti.prepare_target(tp, tnrm, tm)
    layout = nn_layout.SweepLayout(t_lay, order)
    return lambda: treg._icp_p2l_fused_batch(q, maskf, n_src, t_t, tn_t, tc, tv, inits, 0.5,
                                             max_iterations, 1e-6, 1e-6, False, layout)


def _counted(run):
    """(result, launches, counted host pulls) of one ``run()``."""
    from collections import Counter
    from open3d_slam_torch.utils import device as devmod
    before, syncs = Counter(cuda_build.launches), devmod.host_syncs.count
    res = run()
    torch.cuda.synchronize()
    return (res, Counter(cuda_build.launches) - before, devmod.host_syncs.count - syncs)


def _same_result(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in
               ("transformation", "fitness", "inlier_rmse", "num_iterations"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gicp", "p2l"])
@pytest.mark.parametrize("batch,m,n", [(1, 16384, 16384), (1, 4096, 65536), (128, 1024, 2048)])
def test_graphed_loop_equals_eager_loop_on_card(cuda_device, rng, monkeypatch, kind, batch,
                                                m, n):
    """The fused loop replayed as CUDA graphs gives the eager loop's poses,
    fitness, RMSE and iteration counts bit for bit, with the same kernel
    launches and ``done`` reads once captured; the first call adds its
    warm-up's launches (one start, one step); a call with another remainder
    captures that chunk alone; the kernels leave the side stream's scratch
    as they found it."""
    from open3d_slam_torch.ops import gn_graph
    gn_graph.clear()
    kernel = "gicp_normal_eq" if kind == "gicp" else "p2l_normal_eq"
    for iters in (50, 7):
        run = _loop_problem(rng, cuda_device, kind, batch, m, n, iters)
        monkeypatch.setattr(gn_graph, "MODE", "eager")
        want, want_n, want_syncs = _counted(run)
        monkeypatch.setattr(gn_graph, "MODE", "graph")
        first, first_n, _ = _counted(run)
        got, got_n, got_syncs = _counted(run)
        assert _same_result(first, want) and _same_result(got, want)
        assert got_n == want_n and got_syncs == want_syncs
        warm = {(kernel, (batch, m, n)): 2, ("gn_step", (batch,)): 2,
                ("gn_apply", (batch, m, 9 if kind == "gicp" else 3)): 2}
        assert dict(first_n - want_n) == (warm if iters == 50 else {})
    assert float(want.fitness.min()) > 0.5
    dev = want.transformation.device          # cuda:<index>, as the loops key it
    keys, tickets = nn_layout._scratch[(dev, gn_graph._side_stream(dev).cuda_stream)]
    assert bool((keys == -1).all()) and bool((tickets == 0).all())
    gn_graph.clear()


def _refuse_a_capture(rng, dev, monkeypatch):
    """Runs a point-to-plane loop whose iteration reads the host, which its
    capture refuses: the run raises.  Returns the loop's ``run()``, with
    the iteration restored."""
    from open3d_slam_torch.ops import cuda_gn_step
    run = _loop_problem(rng, dev, "p2l", 1, 4096, 16384, 50)
    gn_step = cuda_gn_step.gn_step

    def reads_the_host(out, *args, **kwargs):
        float(out.sum())
        return gn_step(out, *args, **kwargs)

    monkeypatch.setattr(cuda_gn_step, "gn_step", reads_the_host)
    with pytest.raises(RuntimeError):
        run()
    monkeypatch.setattr(cuda_gn_step, "gn_step", gn_step)
    return run


@pytest.mark.cuda
def test_failed_capture_raises_on_card(cuda_device, rng, monkeypatch):
    """A capture that CUDA refuses (a host read inside the iteration)
    raises, keeps no half-made key, leaves this thread on the stream it was
    on, and falls back to nothing; the next call captures anew and equals
    the eager loop."""
    from open3d_slam_torch.ops import gn_graph
    gn_graph.clear()
    before = torch.cuda.current_stream(cuda_device)
    run = _refuse_a_capture(rng, cuda_device, monkeypatch)
    assert gn_graph.captured() == (0, 0)
    assert torch.cuda.current_stream(cuda_device) == before
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    want = run()
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    assert _same_result(run(), want)
    assert gn_graph.captured() == (1, 3)
    gn_graph.clear()


@pytest.mark.cuda
def test_refused_capture_in_graph_nodes_leaves_the_caller_as_it_was_on_card(cuda_device, rng):
    """A call that reads the host cannot be captured: ``graph_nodes``
    raises, leaves this thread on the stream it was on, retires the side
    stream, and leaves no launch of its warm-up or capture counted; the
    next count reads the call's one kernel and replays to its result."""
    from open3d_slam_torch.ops import cuda_gn_step
    dev = torch.device("cuda", torch.cuda.current_device())
    pts = torch.from_numpy(rng.normal(size=(1, 4096, 3)).astype(np.float32)).to(dev)
    T = torch.eye(4, device=dev)[None].contiguous()
    side = gn_graph._side_stream(dev)
    before = torch.cuda.current_stream(dev)
    counts = dict(cuda_build.launches)
    with pytest.raises(RuntimeError):
        gn_graph.graph_nodes(lambda: float(cuda_gn_step.gn_apply(T, pts)[0].sum()), dev)
    assert torch.cuda.current_stream(dev) == before
    assert gn_graph._side_stream(dev) is not side
    assert dict(cuda_build.launches) == counts
    names, (moved, _) = gn_graph.graph_nodes(lambda: cuda_gn_step.gn_apply(T, pts), dev)
    assert len(names) == 1 and "gn_apply" in names[0], names
    assert torch.equal(moved, cuda_gn_step.gn_apply_plain(T, pts)[0])
    assert dict(cuda_build.launches) == counts


def _pose_graph_worker(rng, dev, monkeypatch):
    """The pose-graph solve, eagerly on this thread, then three times on a
    worker thread (captured at its first call, replayed after) while this
    thread copies a scan to the card between the worker's captures
    (``gn_graph.capturing``).  Returns (the eager solve, the worker's
    solves), not synchronised."""
    import threading
    import time
    from open3d_slam_torch.ops import gn_graph, pose_graph as pg
    from open3d_slam_torch.utils.device import to_device
    g = _pg_graph(rng, dev, 128, 512)
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    want = pg.optimize(g, *PG_ARGS)
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    out = {}

    def worker():
        try:
            out["res"] = [pg.optimize(g, *PG_ARGS) for _ in range(3)]
        except Exception as e:       # raised again below
            out["error"] = e

    t = threading.Thread(target=worker)
    t.start()
    scan = rng.normal(size=(32768, 3)).astype(np.float32)
    deadline = time.monotonic() + 120.0
    while t.is_alive() and time.monotonic() < deadline:
        with gn_graph.capturing:
            to_device(scan, dev).sum()
    t.join(timeout=10.0)
    assert not t.is_alive(), "the worker did not finish within its time"
    assert "error" not in out, out.get("error")
    return want, out["res"]


def _solve_gaps(want, res):
    return [[float((p.double() - q.double()).abs().max()) for p, q in zip(r, want)]
            for r in res]


def _solves_equal(want, res):
    return [all(torch.equal(p, q) for p, q in zip(r, want)) for r in res]


@pytest.mark.cuda
def test_failed_capture_then_worker_thread_solves_on_card(cuda_device, rng, monkeypatch):
    """A refused capture, then the pose-graph solve captured and replayed on
    a worker thread, in one function so that no order of the tests can hide
    what the first leaves behind.  The refused capture raises, keeps no key,
    leaves this thread on the stream it was on and retires the side stream
    with its kernel scratch; the worker's solves, compared on this thread's
    stream without a synchronisation, are bit-equal to the eager kernels.
    (Before the repair this thread stayed on the side stream, and the
    comparison read the worker's results before the worker's stream had
    written them.)"""
    from open3d_slam_torch.ops import gn_graph
    gn_graph.clear()
    dev = torch.device("cuda", torch.cuda.current_device())
    side = gn_graph._side_stream(dev)
    before = torch.cuda.current_stream(dev)
    _refuse_a_capture(rng, cuda_device, monkeypatch)
    problems = []
    if torch.cuda.current_stream(dev) != before:
        problems.append(f"after the refused capture this thread is on stream "
                        f"{torch.cuda.current_stream(dev)}, not {before} (the side stream is "
                        f"{side})")
    if gn_graph._streams.get(dev) is side or (dev, side.cuda_stream) in nn_layout._scratch:
        problems.append("the side stream of the refused capture was not retired")
    if gn_graph.captured() != (0, 0):
        problems.append(f"the refused capture kept {gn_graph.captured()}")
    want, res = _pose_graph_worker(rng, cuda_device, monkeypatch)
    gaps = _solve_gaps(want, res)
    equal = _solves_equal(want, res)
    if not all(equal):
        torch.cuda.synchronize()
        problems.append(f"the worker's solves equal the eager one: {equal}, largest gaps "
                        f"{gaps}; after a device synchronize: {_solves_equal(want, res)}")
    gn_graph.clear()
    assert not problems, problems


@pytest.mark.cuda
def test_pose_graph_capture_on_a_worker_thread_on_card(cuda_device, rng, monkeypatch):
    """The solve captured and replayed on a worker thread while this thread
    copies to the card outside its captures (``gn_graph.capturing``), equal
    to the eager kernels.  It runs after ``test_failed_capture_raises_on_card``:
    a failed capture once left this thread on the side stream, and the
    comparisons below then read the worker's results before its stream had
    written them (ROADMAP.md section 3)."""
    from open3d_slam_torch.ops import gn_graph
    gn_graph.clear()
    want, res = _pose_graph_worker(rng, cuda_device, monkeypatch)
    assert all(_solves_equal(want, res)), _solve_gaps(want, res)
    gn_graph.clear()


@pytest.mark.cuda
def test_capture_on_a_worker_thread_on_card(cuda_device, rng, monkeypatch):
    """The online driver's shape: the loop captured and replayed on a worker
    thread while this thread copies data to the card, outside the worker's
    captures (``gn_graph.capturing``, as ``AsyncSlamDriver.add_range_scan``
    holds it), equal to the eager loop."""
    import threading
    import time
    from open3d_slam_torch.ops import gn_graph
    from open3d_slam_torch.utils.device import to_device
    gn_graph.clear()
    run = _loop_problem(rng, cuda_device, "gicp", 1, 4096, 65536, 50)
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    want = run()
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    out = {}

    def worker():
        try:
            out["res"] = [run() for _ in range(3)]
        except Exception as e:       # raised again below
            out["error"] = e

    t = threading.Thread(target=worker)
    t.start()
    scan = rng.normal(size=(32768, 3)).astype(np.float32)
    deadline = time.monotonic() + 120.0
    while t.is_alive() and time.monotonic() < deadline:
        with gn_graph.capturing:
            to_device(scan, cuda_device).sum()
    t.join(timeout=10.0)
    assert not t.is_alive(), "the worker did not finish within its time"
    assert "error" not in out, out.get("error")
    assert all(_same_result(r, want) for r in out["res"])
    gn_graph.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 128, 1024])
def test_solve6_kernel_equals_plain_on_card(cuda_device, rng, batch):
    """The 6x6 solve's kernel bit-equal to its plain version on the card,
    on the strided views a fused kernel's output gives; within float32
    rounding of the library route (``cholesky_ex`` + ``cholesky_solve``)."""
    from open3d_slam_torch.ops import cuda_solve6
    A = rng.normal(size=(batch, 6, 12)).astype(np.float32)
    out = torch.zeros((batch, 8, 128), device=cuda_device)
    out[:, :6, :6] = torch.from_numpy(A @ A.transpose(0, 2, 1)).to(cuda_device)
    out[:, :6, 6] = torch.from_numpy(rng.normal(size=(batch, 6)).astype(np.float32)).to(
        cuda_device)
    JtJ, Jtr, _, _ = tg.unpack(out)
    got = cuda_solve6.solve6(JtJ, Jtr)
    assert torch.equal(got, cuda_solve6.solve6_plain(JtJ, Jtr))
    L, _ = torch.linalg.cholesky_ex(JtJ.contiguous() + 1e-6 * torch.diagonal(
        JtJ, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0 * torch.eye(6, device=cuda_device))
    lib = torch.cholesky_solve(-Jtr[..., None], L)[..., 0]
    scale = lib.abs().amax(-1, keepdim=True)
    assert float(((got - lib).abs() / scale).max()) < 1e-3


GN_TOL = 1e-5    # the step's poses: R entries; t within GN_TOL (1 + |t|)


def _gn_inputs(rng, dev, batch):
    """A fused kernel's (B, 8, 128) output (positive definite JtJ, Jtr, the
    inlier count and d2 sum; some elements with no inliers), the valid
    source counts, the poses P and a state before them with a third of the
    elements done and some changes of fitness and RMSE below the stop
    test's thresholds."""
    from open3d_slam_torch.utils import se3
    A = rng.normal(size=(batch, 6, 12)).astype(np.float32)
    out = np.zeros((batch, 8, 128), np.float32)
    out[:, :6, :6] = A @ A.transpose(0, 2, 1) * rng.uniform(1, 1e3, size=(batch, 1, 1))
    out[:, :6, 6] = rng.normal(scale=0.1, size=(batch, 6))
    out[:, 7, 0] = np.floor(rng.uniform(0, 16384, size=batch))
    out[:, 7, 1] = out[:, 7, 0] * rng.uniform(0.001, 0.05, size=batch)
    out[::7, 7, :2] = 0.0
    n_src = np.floor(rng.uniform(16384, 20000, size=batch)).astype(np.float32)
    xi = np.concatenate([rng.normal(scale=0.3, size=(batch, 3)),
                         rng.normal(scale=5.0, size=(batch, 3))], 1).astype(np.float32)
    P = se3.se3_exp(torch.from_numpy(xi)).contiguous()
    fit = out[:, 7, 0] / np.maximum(n_src, 1.0)
    rmse = np.sqrt(out[:, 7, 1] / np.maximum(out[:, 7, 0], 1.0))
    fit = (fit + np.resize([0.0, 5e-7, 1e-3], batch)).astype(np.float32)
    rmse = (rmse + np.resize([5e-7, 0.0, 1e-3], batch)).astype(np.float32)
    it = rng.integers(0, 30, size=batch).astype(np.int32)
    done = np.arange(batch) % 3 == 1
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    from open3d_slam_torch.ops.gn_graph import GNState
    prev = GNState(P.to(dev), P.to(dev), t(fit), t(rmse), t(it), t(done))
    return t(out), t(n_src), P.to(dev), prev


def _poses_close(got, want, tol=GN_TOL):
    dR = (got[:, :3, :3] - want[:, :3, :3]).abs().amax((-1, -2))
    dt = ((got[:, :3, 3] - want[:, :3, 3]).abs().amax(-1)
          / (1.0 + want[:, :3, 3].abs().amax(-1)))
    return float(torch.maximum(dR, dt).max())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 64, 1024])
@pytest.mark.parametrize("exp_retraction", [True, False])
def test_gn_step_kernel_matches_plain_on_card(cuda_device, rng, batch, exp_retraction):
    """The step kernel against its plain version (the loops' earlier chain)
    on the card, at the start and in an iteration: the solve bit-equal to
    ``solve6_plain`` (the shared ``solve6.cuh``), the fitness, RMSE,
    iteration counts and done flags equal, T the poses swept, the next
    poses within ``GN_TOL`` (the chain's products are cuBLAS's, its B = 1
    solve cuSOLVER's); done elements keep their poses."""
    from open3d_slam_torch.ops import cuda_gn_step, cuda_solve6
    out, n_src, P, prev = _gn_inputs(rng, cuda_device, batch)
    done = []
    for before, ns in ((None, n_src), (prev, n_src), (prev, n_src[:1].reshape(()))):
        delta = torch.empty((batch, 6), device=cuda_device)
        got = cuda_gn_step.gn_step(out, ns, P, before, exp_retraction, 1e-6, 1e-6, delta)
        want = cuda_gn_step.gn_step_plain(out, ns, P, before, exp_retraction, 1e-6, 1e-6)
        JtJ, Jtr, _, _ = tg.unpack(out)
        assert torch.equal(delta, cuda_solve6.solve6_plain(JtJ, Jtr))
        for name in ("T", "fit", "rmse", "it", "done"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert _poses_close(got.P, want.P) <= GN_TOL
        assert torch.equal(got.P[got.done], P[got.done])
        done.append(got.done)
    if batch > 1:                # the iteration with the state's own counts
        assert bool(done[1].any()) and not bool(done[1].all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,lead,cov", [
    (1, 16384, 1, True), (1, 4096, 1, True), (1, 16384, 1, False), (64, 2048, 0, False),
    (4, 1001, 4, True), (3, 1024, 1, True), (128, 1024, 128, False)])
def test_gn_apply_kernel_equals_plain_on_card(cuda_device, rng, batch, m, lead, cov):
    """The point-apply kernel bit-equal to its plain version on the card:
    points shared by every pose (M, 3) or (1, M, 3), or one cloud a pose;
    with and without covariances; M not a multiple of 4 (one point at a
    time) and a batch stride that breaks 16-byte alignment."""
    from open3d_slam_torch.ops import cuda_gn_step
    from open3d_slam_torch.utils import se3
    xi = np.concatenate([rng.normal(scale=0.5, size=(batch, 3)),
                         rng.normal(scale=10.0, size=(batch, 3))], 1).astype(np.float32)
    T = se3.se3_exp(torch.from_numpy(xi)).contiguous().to(cuda_device)
    shape = (m, 3) if lead == 0 else (lead, m, 3)
    pts = torch.from_numpy(rng.normal(scale=20.0, size=shape).astype(np.float32)).to(
        cuda_device)
    c6 = None
    if cov:
        c6 = torch.from_numpy(rng.normal(size=(max(lead, 1), m, 6)).astype(np.float32)).to(
            cuda_device)
    got = cuda_gn_step.gn_apply(T, pts, c6)
    want = cuda_gn_step.gn_apply_plain(T, pts, c6)
    assert torch.equal(got[0], want[0]) and got[0].is_contiguous()
    assert (got[1] is None) == (not cov)
    if cov:
        assert torch.equal(got[1], want[1]) and got[1].is_contiguous()
    if lead > 1:                 # a batch stride that is not a multiple of 4 floats
        wide = torch.zeros((lead, m + 1, 3), device=cuda_device)
        wide[:, :m] = pts
        assert torch.equal(cuda_gn_step.gn_apply(T, wide[:, :m], None)[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gicp", "p2l"])
def test_graphed_iteration_is_the_sweep_and_two_kernels_on_card(cuda_device, rng,
                                                                 monkeypatch, kind):
    """One iteration of the B = 1 loop, as the loop's graphs capture it,
    puts on the card the point apply, K1's or K4's sweep and row kernel,
    and the step, and nothing else (counted from a CUDA graph of the
    iteration on the loop's own static buffers)."""
    from open3d_slam_torch.ops import gn_graph
    gn_graph.clear()
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    run = _loop_problem(rng, cuda_device, kind, 1, 4096, 16384, 8)
    run()
    (loop,) = gn_graph._entries.values()
    names, state = gn_graph.graph_nodes(lambda: loop.step(loop.state), cuda_device)
    rows = "gicp_rows" if kind == "gicp" else "p2l_rows"
    assert len(names) == 4, names
    assert ("gn_apply" in names[0] and "nn_sweep" in names[1] and rows in names[2]
            and "gn_step" in names[3]), names
    assert torch.equal(state.T, loop.state.P)
    gn_graph.clear()


P2P_TOL = 1e-5   # R entries; t within P2P_TOL (1 + |p_bar|), as tests/test_torch_p2p.py


def _p2p_inputs(rng, dev, b, m):
    """Correspondences of ``b`` hypotheses: rotated, shifted and noisy
    copies of anisotropic clouds, 80% inliers; with b > 3 the last three
    are a reflection (det H < 0), a planar source (rank 2) and no inliers,
    and with b > 4 the fourth from last is a noise-free line (rank 1)."""
    pts = rng.normal(size=(b, m, 3)) * np.array([4.0, 2.5, 1.0]) + rng.normal(
        scale=10.0, size=(b, 1, 3))
    ang = rng.uniform(-0.4, 0.4, size=b)
    R = np.zeros((b, 3, 3))
    R[:, 0, 0] = R[:, 1, 1] = np.cos(ang)
    R[:, 0, 1], R[:, 1, 0] = -np.sin(ang), np.sin(ang)
    R[:, 2, 2] = 1.0
    w = rng.uniform(size=(b, m)) < 0.8
    if b > 3:
        pts[-2, :, 2] = 0.0
        w[-1] = False
    shift = rng.normal(scale=0.5, size=(b, 1, 3))
    q = np.einsum("bij,bmj->bmi", R, pts) + shift + rng.normal(scale=0.03, size=(b, m, 3))
    if b > 3:
        q[-3, :, 2] = -q[-3, :, 2]
    if b > 4:
        d = rng.normal(size=3)
        pts[-4] = pts[-4].mean(0) + rng.normal(scale=2.0, size=(m, 1)) * (d / np.linalg.norm(d))
        q[-4] = pts[-4] @ R[-4].T + shift[-4]
    return tuple(torch.from_numpy(a).to(dev) for a in (pts.astype(np.float32),
                                                       q.astype(np.float32), w))


# The path's shapes (the mid stage's 64 x 1024, the tracking scans' 1 x 16384
# and 1 x 4096), then M at the cluster's edges (ops/cuda_p2p.cluster_size: a
# CTA takes up to 2048 points until the cluster has 8): one point, just
# under and over a chunk, M % 4 != 0 (hypotheses at any offset modulo 16
# bytes), staged shared memory just under 48 KB with the static (the
# opt-in's edge), past the cap (8192 points a CTA, staged) and past what a
# CTA can stage (10001 points a CTA, read from device memory twice).
P2P_SHAPES = [(64, 1024), (1, 16384), (1, 4096), (3, 1), (5, 2047), (5, 2049), (6, 4097),
              (2, 1955), (1, 65536), (2, 80001)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", P2P_SHAPES)
def test_p2p_step_kernel_matches_plain_on_card(cuda_device, rng, b, m):
    """The Kabsch step's kernel against its plain version (``torch.linalg.svd``
    on the card): R within P2P_TOL, t within P2P_TOL (1 + |p_bar|), no
    inliers give I exactly; collinear inliers (R not determined by H, so not
    held against the plain version) give the smallest rotation that takes
    the source line onto the target line; two calls are bit-equal, and each
    hypothesis alone gives its row of the batch bit for bit (the cluster
    size depends on M alone; no atomics)."""
    from open3d_slam_torch.ops import cuda_p2p
    pts, q, w = _p2p_inputs(rng, cuda_device, b, m)
    got = cuda_p2p.p2p_step(pts, q, w)
    want = cuda_p2p.p2p_step_plain(pts, q, w)
    assert torch.equal(got, cuda_p2p.p2p_step(pts, q, w))
    held = torch.ones(b, dtype=torch.bool, device=cuda_device)
    if b > 4:
        held[-4] = False
    assert float((got[held, :3, :3] - want[held, :3, :3]).abs().max()) <= P2P_TOL
    _, p_bar, _ = cuda_p2p.p2p_moments(pts, q, w)
    t_err = (got[:, :3, 3] - want[:, :3, 3]).abs().amax(-1)[held]
    assert bool((t_err <= P2P_TOL * (1.0 + p_bar[held].norm(dim=-1))).all())
    assert torch.equal(got[:, 3], want[:, 3])
    if b > 3:
        assert torch.equal(got[-1], torch.eye(4, device=cuda_device))
        H, _, _ = cuda_p2p.p2p_moments(pts[-3:-2], q[-3:-2], w[-3:-2])
        assert float(torch.linalg.det(H.double())) < 0
    if b > 4:
        R = got[-4, :3, :3].double()
        P, Q = (x[-4][w[-4]].double() for x in (pts, q))
        P, Q = P - P.mean(0), Q - Q.mean(0)
        k = int(P.norm(dim=1).argmax())
        a, c = P[k] / P[k].norm(), Q[k] / Q[k].norm()
        eye = torch.eye(3, dtype=torch.float64, device=cuda_device)
        assert float((R @ R.T - eye).abs().max()) <= P2P_TOL
        assert float((R @ a - c).abs().max()) <= P2P_TOL
        # The smallest such rotation turns by the angle between the lines.
        assert abs(float(torch.trace(R) - (1.0 + 2.0 * (a @ c)))) <= P2P_TOL
    for i in sorted({0, b - 1, max(b - 4, 0)}):
        assert torch.equal(cuda_p2p.p2p_step(pts[i:i + 1], q[i:i + 1], w[i:i + 1]),
                           got[i:i + 1])


@pytest.mark.cuda
def test_p2p_step_failed_build_or_launch_raises_on_card(cuda_device, monkeypatch):
    """A launch the card refuses (a grid of no blocks) raises; a source nvcc
    refuses raises at the build, and nothing gives way to the plain version."""
    from open3d_slam_torch.ops import cuda_p2p
    empty = torch.empty((0, 8, 3), device=cuda_device)
    with pytest.raises(RuntimeError):
        cuda_p2p._launch_p2p(empty, empty, torch.empty((0, 8), dtype=torch.bool,
                                                       device=cuda_device))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["--no-such-flag"])
    pts = torch.zeros((1, 8, 3), device=cuda_device)
    with pytest.raises(RuntimeError):
        cuda_p2p.p2p_step(pts, pts, torch.ones((1, 8), dtype=torch.bool, device=cuda_device))


def _p2p_problem(rng, dev, batch, m, n):
    """Point-to-point ICP of an m-point source drawn from an n-point target
    of ground and wall planes, from ``batch`` perturbed inits (the mid
    stage's shape at batch 64).  Returns (source, grid, inits)."""
    from open3d_slam_torch.utils import se3
    pts = _planes(rng, n)
    mask = np.ones(n, bool)
    mask[-(n // 50):] = False
    grid = hashgrid.build(tpc.PointCloud(torch.from_numpy(pts).to(dev),
                                         torch.from_numpy(mask).to(dev)), 2.0)
    src = pts[rng.choice(n - n // 50, m, replace=m > n - n // 50)] + rng.normal(
        scale=0.03, size=(m, 3)).astype(np.float32)
    smask = rng.uniform(size=m) > 0.05
    source = tpc.PointCloud(torch.from_numpy(src).to(dev), torch.from_numpy(smask).to(dev))
    xi = np.concatenate([rng.normal(scale=0.03, size=(batch, 3)),
                         rng.normal(scale=0.3, size=(batch, 3))], 1).astype(np.float32)
    return source, grid, se3.se3_exp(torch.from_numpy(xi).to(dev)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n", [(64, 1024, 16384), (1, 4096, 16384)])
def test_graphed_point_to_point_equals_eager_on_card(cuda_device, rng, monkeypatch, batch, m,
                                                     n):
    """The point-to-point loop replayed as CUDA graphs gives the eager loop's
    poses, fitness, RMSE and iteration counts bit for bit, with the same
    launches and ``done`` reads once captured (the first call adds its
    warm-up's: a start and a step); a call with another remainder captures
    that chunk alone; no chunk of the eager loop synchronises (torch's sync
    debug mode, set to raise, around each chunk)."""
    from open3d_slam_torch.ops import gn_graph, registration as treg
    gn_graph.clear()
    steps = gn_graph.steps

    def no_sync_steps(step, state, k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return steps(step, state, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    for iters in (12, 7):
        problem = _p2p_problem(rng, cuda_device, batch, m, n)

        def run():
            return treg.batched_icp_point_to_point(*problem, 2.0, max_iterations=iters)

        monkeypatch.setattr(gn_graph, "MODE", "eager")
        monkeypatch.setattr(gn_graph, "steps", no_sync_steps)
        want, want_n, want_syncs = _counted(run)
        monkeypatch.setattr(gn_graph, "steps", steps)
        monkeypatch.setattr(gn_graph, "MODE", "graph")
        first, first_n, _ = _counted(run)
        got, got_n, got_syncs = _counted(run)
        assert _same_result(first, want) and _same_result(got, want)
        assert got_n == want_n and got_syncs == want_syncs <= -(-iters // 4)
        warm = {("nn_argmin_within", (batch, m, n)): 2, ("p2p_step", (batch, m)): 1}
        assert dict(first_n - want_n) == (warm if iters == 12 else {})
        assert want_n[("p2p_step", (batch, m))] >= 1
    assert float(want.fitness.min()) > 0.5
    gn_graph.clear()


@pytest.mark.cuda
def test_batched_point_to_point_equals_independent_runs_on_card(cuda_device, rng):
    """On the card, graphed, each hypothesis of a batch ends where its own
    ``icp_point_to_point`` run ends, bit for bit."""
    from open3d_slam_torch.ops import gn_graph, registration as treg
    gn_graph.clear()
    source, grid, inits = _p2p_problem(rng, cuda_device, 8, 1024, 16384)
    batch = treg.batched_icp_point_to_point(source, grid, inits, 2.0, max_iterations=12)
    for i in range(8):
        one = treg.icp_point_to_point(source, grid, inits[i], 2.0, max_iterations=12)
        assert torch.equal(batch.transformation[i], one.transformation)
        assert torch.equal(batch.fitness[i], one.fitness)
        assert torch.equal(batch.inlier_rmse[i], one.inlier_rmse)
        assert int(batch.num_iterations[i]) == int(one.num_iterations)
    gn_graph.clear()


# The pose-graph LM step (``ops/cuda_pose_graph.py``, ``csrc/pose_graph.cu``):
# r within ``cuda_pose_graph.residual_tolerance`` of the plain version's (1e-5
# of 1 + the edge's largest component, plus twice the spread of float32 logs
# of the edge's input moved by one rounding: the SE(3) log's float32
# conditioning, which both share and which reaches metres for rotations of
# ~1e-3 rad with metres of translation); w and the blocks within 1e-5 of
# their largest entry of the same quantities in float64 from the kernel's own
# r; H and b within 1e-5 of their largest entry of the plain assembly of the
# same blocks (one-hot einsums sum in another order); the step's X within
# 1e-6 of (1 + |X|) of the plain step's on the same solve (poses metres from
# the origin: 1e-6 alone is under an ulp); one whole iteration's X within
# that plus three times the plain float32 iteration's distance from float64
# (the residual's conditioning again); the whole solve graphed bit-equal to
# the eager kernels, its pruning the plain route's, and its poses no farther
# from the float64 solve than three times the plain route's distance plus 1e-4
# (the accept decisions and the residuals' conditioning amplify rounding).
PG_SHAPES = [(16, 32), (128, 512)]


def _pg_graph(rng, dev, n_cap, e_cap):
    """A drifting arc of ``n_cap - 2`` nodes with odometry edges (Open3D's
    convention, X_t^-1 X_s = T), true loop closures and bogus ones
    (uncertain), padded to ``e_cap`` edges with the last two masked out."""
    from scipy.spatial.transform import Rotation
    from open3d_slam_torch.ops import pose_graph as pg

    def rt(yaw, x, y, z=0.0):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("z", yaw).as_matrix()
        T[:3, 3] = [x, y, z]
        return T

    n = n_cap - 2
    gt = [rt(0.1 * i, 10.0 * np.cos(0.05 * i), 10.0 * np.sin(0.05 * i)) for i in range(n)]
    bias = rt(0.004, 0.02, 0.0)
    nodes = [np.eye(4)]
    for i in range(n - 1):
        nodes.append(nodes[-1] @ np.linalg.inv(gt[i]) @ gt[i + 1] @ bias)
    edges = [(i, i + 1, np.linalg.inv(np.linalg.inv(gt[i]) @ gt[i + 1] @ bias), 50.0, False)
             for i in range(n - 1)]
    while len(edges) < e_cap - 2:
        s, t = sorted(rng.choice(n, 2, replace=False))[::-1]
        if rng.uniform() < 0.7:
            T = np.linalg.inv(gt[t]) @ gt[s] @ rt(rng.normal(0, 0.002), *rng.normal(0, 0.01, 2))
            edges.append((s, t, T, 20.0, True))
        else:
            edges.append((s, t, rt(rng.uniform(-2, 2), *rng.uniform(-5, 5, 2)), 100.0, True))
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cap, 1, 1))
    poses[:n] = np.stack(nodes)
    src, tgt = np.zeros(e_cap, np.int64), np.zeros(e_cap, np.int64)
    T = np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1))
    info = np.tile(np.eye(6, dtype=np.float32), (e_cap, 1, 1))
    unc, emask = np.zeros(e_cap, bool), np.zeros(e_cap, bool)
    for k, (s, t, Tk, scale, u) in enumerate(edges):
        src[k], tgt[k], T[k], info[k], unc[k], emask[k] = s, t, Tk, np.eye(6) * scale, u, True
    f = lambda a: torch.from_numpy(a).to(dev)
    return pg.PoseGraphData(node_poses=f(poses), node_mask=f(np.arange(n_cap) < n),
                            edge_source=f(src), edge_target=f(tgt), edge_transform=f(T),
                            edge_information=f(info), edge_uncertain=f(unc),
                            edge_mask=f(emask))


PG_ARGS = (1000.0, 2.0, 0.25, 0)


def _pg_inputs(g):
    a, b = g.edge_target, g.edge_source
    info = g.edge_information
    mu = 2.0 * torch.where(g.edge_mask, info[:, 5, 5], 0.0).sum() / g.edge_mask.sum()
    return a, b, mu


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", PG_SHAPES)
def test_pose_graph_kernels_match_plain_on_card(cuda_device, rng, n, e):
    """Each kernel against its plain version on the same card tensors, and
    bit-equal across calls; one whole LM iteration (the two kernels around
    the library Cholesky, then the step) against the plain iteration."""
    from open3d_slam_torch.ops import cuda_pose_graph as cpg
    g = _pg_graph(rng, cuda_device, n, e)
    a, b, mu = _pg_inputs(g)
    X = g.node_poses
    args = (X, a, b, g.edge_transform, g.edge_information, g.edge_uncertain, g.edge_mask, mu)
    got, want = cpg.pg_linearize(*args), cpg.pg_linearize_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, cpg.pg_linearize(*args)))
    assert bool(((got.r.double() - want.r.double()).abs()
                 <= cpg.residual_tolerance(X, a, b, g.edge_transform)).all())
    ref = cpg.linearize_at(X.double(), a, b, g.edge_information.double(), g.edge_uncertain,
                           g.edge_mask, mu.double(), got.r.double())
    for k in ("w", "H_ss", "H_st", "H_tt", "b_s", "b_t", "cost"):
        x, y = getattr(got, k).double(), getattr(ref, k)
        assert float((x - y).abs().max()) <= 1e-5 * max(float(y.abs().max()), 1.0), k
    prior = (torch.arange(n, device=cuda_device) == 0).float() * 1e6 + 1e-8
    damping = torch.full((), 1e-4, device=cuda_device)
    H, bb, cost = cpg.pg_assemble(got, a, b, prior, damping)
    Hp, bp, costp = cpg.pg_assemble_plain(got, a, b, prior, damping)
    assert all(torch.equal(x, y) for x, y in zip((H, bb, cost),
                                                 cpg.pg_assemble(got, a, b, prior, damping)))
    assert float((H - Hp).abs().max()) <= 1e-5 * float(Hp.abs().max())
    assert float((bb - bp).abs().max()) <= 1e-5 * max(float(bp.abs().max()), 1.0)
    assert abs(float(cost) - float(costp)) <= 1e-5 * float(costp)
    delta = torch.cholesky_solve(-bb[:, None], torch.linalg.cholesky_ex(H)[0])[:, 0]
    step_args = (X, delta, a, b, g.edge_transform, g.edge_information, got.w, cost, damping)
    Xk, dk = cpg.pg_step(*step_args)
    Xp, dp = cpg.pg_step_plain(*step_args)
    assert all(torch.equal(x, y) for x, y in zip((Xk, dk), cpg.pg_step(*step_args)))
    assert torch.equal(dk, dp) and float(dk) == pytest.approx(5e-5)      # accepted
    assert bool(((Xk - Xp).abs() <= 1e-6 * (1.0 + Xp.abs())).all())
    # The whole iteration, plain from end to end, in float32 and float64.
    def plain_iteration(dtype):
        t = [x.to(dtype) for x in (X, g.edge_transform, g.edge_information, mu, prior,
                                   damping)]
        lin = cpg.pg_linearize_plain(t[0], a, b, t[1], t[2], g.edge_uncertain, g.edge_mask,
                                     t[3])
        Hq, bq, cq = cpg.pg_assemble_plain(lin, a, b, t[4], t[5])
        dq = torch.cholesky_solve(-bq[:, None], torch.linalg.cholesky_ex(Hq)[0])[:, 0]
        return cpg.pg_step_plain(t[0], dq, a, b, t[1], t[2], lin.w, cq, t[5])[0]

    Xq, X64 = plain_iteration(torch.float32), plain_iteration(torch.float64)
    own = float((Xq.double() - X64).abs().max())
    assert bool(((Xk - Xq).abs() <= 1e-6 * (1.0 + Xq.abs()) + 3.0 * own).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,iters", [(16, 32, 20), (128, 512, 25)])
def test_graphed_pose_graph_solve_equals_eager_kernels_on_card(cuda_device, rng, monkeypatch,
                                                              n, e, iters):
    """The solve replayed as one CUDA graph gives the eager kernels' poses,
    weights and pruning bit for bit, with the same launches once captured
    (the first call adds its warm-up run's) and no counted pull; pruning
    equal to the plain route's, and no farther from the float64 solve than
    it; a second graph through the same key leaves the first result
    alone."""
    from open3d_slam_torch.ops import gn_graph, pose_graph as pg
    gn_graph.clear()
    graphs = [_pg_graph(rng, cuda_device, n, e) for _ in range(2)]
    run = lambda g: (lambda: pg.optimize(g, *PG_ARGS, max_iterations=iters))
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    want, want_n, want_syncs = _counted(run(graphs[0]))
    other, _, _ = _counted(run(graphs[1]))
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    first, first_n, _ = _counted(run(graphs[0]))
    got, got_n, got_syncs = _counted(run(graphs[0]))
    kept = [t.clone() for t in got]
    got2, _, _ = _counted(run(graphs[1]))
    assert want_syncs == got_syncs == 0 and gn_graph.captured() == (1, 1)
    assert got_n == want_n and dict(first_n - want_n) == dict(want_n)
    assert set(k for k, _ in want_n) == {"pg_linearize", "pg_assemble", "pg_step"}
    assert want_n[("pg_step", (n, e))] == 2 * iters
    for x in (first, got, kept):
        assert all(torch.equal(p, q) for p, q in zip(x, want))
    assert all(torch.equal(p, q) for p, q in zip(got2, other))
    # Against the plain route: the same pruning, and no farther from the
    # float64 solve than the plain float32 route is (three times that, plus
    # 1e-4): the graph's residuals are float32-ill-conditioned in places
    # (``cuda_pose_graph.residual_tolerance``), and LM follows them.
    plain = pg.optimize_plain(graphs[0], *PG_ARGS, max_iterations=iters)
    assert torch.equal(plain[2], want[2]) and bool(want[2].any())
    g64 = pg.PoseGraphData(**{k: v.double() if v.is_floating_point() else v
                              for k, v in pg._fields(graphs[0]).items()})
    truth = pg.optimize_plain(g64, *PG_ARGS, max_iterations=iters)[0]
    own = float((plain[0].double() - truth).abs().max())
    assert float((want[0].double() - truth).abs().max()) <= 1e-4 + 3.0 * own
    gn_graph.clear()


@pytest.mark.cuda
def test_pose_graph_refused_launch_or_build_raises_on_card(cuda_device, rng, monkeypatch):
    """A launch the card refuses (a row strip past the shared memory a block
    may have) and a build nvcc refuses both raise; nothing falls back."""
    from open3d_slam_torch.ops import cuda_pose_graph as cpg
    n, e = 2000, 4
    f32 = dict(dtype=torch.float32, device=cuda_device)
    blocks = cpg.EdgeBlocks(torch.zeros(e, 6, **f32), torch.zeros(e, **f32),
                            *(torch.zeros(e, 6, 6, **f32) for _ in range(3)),
                            torch.zeros(e, 6, **f32), torch.zeros(e, 6, **f32),
                            torch.zeros(e, **f32))
    ends = torch.zeros(e, dtype=torch.int64, device=cuda_device)
    with pytest.raises(RuntimeError):
        cpg.pg_assemble(blocks, ends, ends, torch.ones(n, **f32), torch.zeros((), **f32))
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["--no-such-flag"])
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cpg.pg_assemble(blocks, ends, ends, torch.ones(16, **f32), torch.zeros((), **f32))


# --- the scan preprocess chain as one CUDA graph per key ------------------------

_VLP16_SCANS = {}


def _vlp16_scans(n: int = 8):
    """``n`` VLP-16 sweeps of the yard circle at 10 Hz (rendered on the host
    once per process)."""
    if n not in _VLP16_SCANS:
        from open3d_slam_torch.io import lidar_sim
        spec = lidar_sim.SimSequenceSpec(name="preprocess_graph", n_scans=n, seed=0,
                                         traj_kwargs=dict(radius=12.0, period=24.3))
        _VLP16_SCANS[n] = lidar_sim.make_sim_sequence(spec, cache_dir="")
    return _VLP16_SCANS[n]


def _vlp16_params():
    from open3d_slam_torch.utils import config as cfg
    return cfg.load_parameters_from_file(cfg.config_path("velodyne_puck16.yaml"))


def _preprocess_owner(kind, dev):
    """The configuration's odometry (ratio 1.0, normals of the voxelized
    cloud) or scan-to-map owner (ratio 0.25, normals at the kept points)."""
    from open3d_slam_torch.models.odometry import LidarOdometry
    from open3d_slam_torch.models.scan_to_map_registration import ScanToMapIcp
    p = _vlp16_params()
    cap = p.capacities.processed_scan
    if kind == "odometry":
        return LidarOdometry(p.odometry, processed_capacity=cap, device=dev)
    return ScanToMapIcp(p.mapper, processed_capacity=cap, device=dev)


def _raw_cloud(points, dev):
    return tpc.from_numpy(points, capacity=_vlp16_params().capacities.raw_scan, device=dev)


def _cloud_channels(pc):
    return tuple(t for t in (pc.points, pc.mask, pc.normals, pc.colors) if t is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["odometry", "mapper"])
def test_graphed_preprocess_chain_equals_eager_on_card(cuda_device, monkeypatch, kind):
    """Four successive scans through each owner's chain, eager and
    graphed, each owner's generator advancing: the clouds are equal bit for
    bit, the first graphed call's cloud is not overwritten by the later
    replays, the eager chain reads nothing back (sync debug mode "error"),
    nor do the replays, and once captured a replay counts the eager chain's
    launches.  One key, one graph."""
    gn_graph.clear()
    scans = [_raw_cloud(s, cuda_device) for s in _vlp16_scans().scans[:4]]
    owners = {"eager": _preprocess_owner(kind, cuda_device),
              "graph": _preprocess_owner(kind, cuda_device)}
    outs = {"eager": [], "graph": []}
    launches = {"eager": [], "graph": []}
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    _preprocess_owner(kind, cuda_device).preprocess(scans[0])   # builds, tables

    def no_host_read(owner, scan, check):
        torch.cuda.set_sync_debug_mode("error" if check else "default")
        try:
            return owner.preprocess(scan)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    for i, scan in enumerate(scans):
        for mode, owner in owners.items():
            monkeypatch.setattr(gn_graph, "MODE", mode)
            # The capture's own synchronisation is torch's, not the chain's.
            check = i > 0 or mode == "eager"
            out, n, syncs = _counted(lambda: no_host_read(owner, scan, check))
            assert syncs == 0
            outs[mode].append(out)
            launches[mode].append(n)
        if i == 0:
            first = [t.clone() for t in _cloud_channels(outs["graph"][0])]
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    for want, got in zip(outs["eager"], outs["graph"]):
        assert len(_cloud_channels(want)) == len(_cloud_channels(got)) == 3
        assert all(torch.equal(a, b) for a, b in zip(_cloud_channels(want),
                                                      _cloud_channels(got)))
    assert all(torch.equal(a, b) for a, b in zip(first, _cloud_channels(outs["graph"][0])))
    assert not torch.equal(outs["graph"][0].points, outs["graph"][1].points)
    assert launches["graph"][1:] == launches["eager"][1:]
    assert {k for k, _ in launches["eager"][0]} == {"kth_neighbor_d2_within",
                                                     "radius_moments_at"}
    assert dict(launches["graph"][0] - launches["eager"][0]) == dict(launches["eager"][0])
    assert gn_graph.captured() == (1, 1)
    gn_graph.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["odometry", "mapper"])
def test_preprocess_chain_graph_holds_k2_sweeps_and_merges_on_card(cuda_device, kind):
    """One call of the chain, captured as its key's graph is, holds K2's
    prepass and moments sweeps with their merges, one of each; it reads
    nothing back (a capture refuses a host read); its replay equals the
    eager chain."""
    from open3d_slam_torch.models import odometry
    gn_graph.clear()
    owner = _preprocess_owner(kind, cuda_device)
    sp = owner.params.scan_processing
    cap = owner.processed_capacity
    n_keep = int(round(cap * sp.down_sampling_ratio)) if sp.down_sampling_ratio < 1.0 else 0
    cropper = owner.cropper if kind == "odometry" else owner.map_builder_cropper
    icp = owner.params.scan_matcher.icp
    scan = _raw_cloud(_vlp16_scans().scans[0], cuda_device)
    scores = owner.draw_scores(cap) if n_keep else None
    args = (cropper, float(icp.max_distance_knn), sp.voxel_size, cap, n_keep,
            tpc.padded_capacity(max(n_keep, 1)), True, icp.knn)
    want = _cloud_channels(odometry._chain(scan, scores, *args))
    names, got = gn_graph.graph_nodes(lambda: _cloud_channels(odometry._chain(scan, scores,
                                                                              *args)),
                                      cuda_device)
    kernels = [n for n in names if not n.startswith("<")]
    for k2 in ("kth_sweep", "kth_merge", "moments_sweep", "moments_reduce"):
        assert sum(k2 in n for n in kernels) == 1, (k2, kernels)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    gn_graph.clear()


@pytest.mark.cuda
def test_vlp16_replay_captures_two_preprocess_keys_on_card(cuda_device, monkeypatch):
    """A short pipelined replay of the VLP-16 configuration captures
    exactly two preprocess keys (the odometry's and the mapper's), each
    replayed once a scan under its layer's preprocess span, and gives the
    eager replay's poses bit for bit."""
    import collections
    from open3d_slam_torch.models.slam_wrapper import SlamWrapper
    from open3d_slam_torch.utils.timeutil import telemetry
    seq = _vlp16_scans()
    poses = {}
    for mode in ("eager", "graph"):
        gn_graph.clear()
        monkeypatch.setattr(gn_graph, "MODE", mode)
        slam = SlamWrapper(_vlp16_params(), device="cuda")
        telemetry.start_recording()
        try:
            for points, ts in zip(seq.scans, seq.timestamps):
                slam.process_scan_pipelined(points, ts)
            slam._flush_map_pending()
        finally:
            rec = telemetry.stop_recording()
        poses[mode] = np.stack(slam.get_trajectory()[1])
        keys = [k for (k, capture), _ in gn_graph._entries.items()
                if capture and k[0] == "preprocess"]
        spans = collections.Counter(sp.name for sp in rec.spans)
        replays = {name: rec.counters.get((name, "graph_replays"), 0)
                   for name in ("odometry.preprocess", "mapper.preprocess")}
        assert spans["odometry.preprocess"] == len(seq.scans)
        assert spans["mapper.preprocess"] >= len(seq.scans) - 2
        if mode == "eager":
            assert keys == [] and replays == {"odometry.preprocess": 0,
                                              "mapper.preprocess": 0}
        else:
            cap = _vlp16_params().capacities.processed_scan
            assert sorted(k[5] for k in keys) == [0, round(cap * 0.25)]
            assert all(replays[name] == spans[name] for name in replays)
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    assert np.array_equal(poses["eager"], poses["graph"])
    gn_graph.clear()
