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
from open3d_slam_torch.ops import cuda_knn as tk, hashgrid, nn_layout
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tcn.kth_neighbor_d2_within(q, pts, mask, k, 3.0, layout)
        torch.cuda.synchronize()
    names = [e.name for e in sorted((e for e in prof.events()
                                     if e.device_type == torch.autograd.DeviceType.CUDA),
                                    key=lambda e: e.time_range.start)]
    splits = tcn.plan_splits(m, layout.target.boxes.shape[0], cuda_device,
                             tcn._KTH_MAX_SPLITS)
    assert len(names) == (1 if splits == 1 else 2) and "kth_sweep" in names[0], names
    assert splits == 1 or "kth_merge" in names[1], names


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
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = tk.nn_argmin_within(queries, None, layout, 0.3)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in sorted((e for e in prof.events() if e.device_type == cuda),
                                    key=lambda e: e.time_range.start)]
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
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in sorted((e for e in prof.events() if e.device_type == cuda),
                                    key=lambda e: e.time_range.start)]
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
