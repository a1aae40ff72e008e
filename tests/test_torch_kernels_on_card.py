"""Kernels K1, K2, K3 and K4 on the card against their plain PyTorch versions
on the same card tensors, at the layouts the JAX signatures allow: one shared
2-D target or one target per batch element, with and without the tile skip,
sizes that do not fill the last block or tile; for K3 and K4 also every
target masked and exact ties.

Marked ``cuda``: they skip without a CUDA card and ``nvcc``.  This file
imports neither JAX nor the JAX package, so it runs on a card's machine that
has no JAX, without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_on_card.py

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
from open3d_slam_torch.ops import cuda_knn as tk
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
    prep = [tg.prepare_target(p, c, v) for p, v, c in tgts]
    td = prep[0][0] if shared_target else torch.stack([t for t, _ in prep])
    tv = prep[0][1] if shared_target else torch.stack([v for _, v in prep])
    q = torch.stack([p for p, _, _ in srcs]).contiguous()
    qc = torch.stack([tg.cov6_from_full(c) for _, _, c in srcs]).contiguous()
    qm = torch.stack([v.to(torch.float32)[:, None] for _, v, _ in srcs])
    if shared_target and batch == 1:
        qm = qm[0]
    aabb = None
    if shared_target and n % tg.TILE_N == 0:
        aabb = tg.tile_aabbs(tgts[0][0], tgts[0][1]).contiguous()
    r2 = torch.full((1, 1), 0.25, device=dev)
    return (q, qm.contiguous(), qc, td.contiguous(), tv.contiguous(), r2), aabb


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n,shared", [
    (1, 4096, 16384, True),     # one shared target, with the tile skip
    (3, 1000, 3000, False),     # a target per element; partial block/tile
    (2, 640, 2048, True),       # a shared target across a batch
])
def test_gicp_kernel_matches_plain_on_card(cuda_device, rng, batch, m, n, shared):
    args, aabb = _gicp_problem(rng, cuda_device, batch, m, n, shared)
    want = tg.gicp_normal_eq_plain(*args)
    for t_aabb in ([None, aabb] if aabb is not None else [None]):
        before = cuda_build.launches[("gicp_normal_eq", (batch, m, n))]
        got = tg.gicp_normal_eq(*args, t_aabb)
        assert cuda_build.launches[("gicp_normal_eq", (batch, m, n))] == before + 1
        assert got.shape == (batch, 8, 128)
        assert float(want[:, 7, 0].min()) > 0.5 * m
        dis = tg.plain_disagreement(got, want)
        assert dis["n_in_equal"] and dis["rest_equal"], dis
        assert dis["gram"] <= 1e-5 and dis["d2s"] <= 1e-5, dis


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
    prep = [ti.prepare_target(t.points, t.normals, t.mask) for t in tgts]
    target = prep[0] if shared else tuple(torch.stack(a).contiguous() for a in zip(*prep))
    srcs = []
    for b in range(batch):
        base = tgts[0 if shared else b].points.cpu().numpy()
        srcs.append(base[rng.choice(n, m, replace=m > n)] +
                    rng.normal(scale=0.05, size=(m, 3)).astype(np.float32))
    q = torch.from_numpy(np.stack(srcs)).to(dev).contiguous()
    qm = torch.from_numpy((rng.uniform(size=(batch, m, 1)) > 0.05).astype(np.float32)).to(dev)
    qm = (qm[0] if shared else qm).contiguous()
    return (q, qm) + target + (torch.full((1, 1), 0.25, device=dev),)


def _p2l_on_card(args):
    """K4 and its plain version on the same card tensors; the launch is
    counted once."""
    key = ("p2l_normal_eq", (args[0].shape[0], args[0].shape[1], args[2].shape[-1]))
    before = cuda_build.launches[key]
    got = ti.p2l_normal_eq(*args)
    assert cuda_build.launches[key] == before + 1
    want = ti.p2l_normal_eq_plain(*args)
    assert got.shape == want.shape == (args[0].shape[0], 8, 128)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n,shared", [
    (1, 8192, 32768, True),     # the final registration: B = 1, target split
    (1, 32768, 65536, True),    # the refinement of an odometry constraint
    (64, 2048, 8192, True),     # a hypothesis batch against one map
    (3, 1000, 3001, False),     # a target per element; partial block/tile
])
def test_p2l_kernel_matches_plain_on_card(cuda_device, rng, batch, m, n, shared):
    got, want = _p2l_on_card(_p2l_problem(rng, cuda_device, batch, m, n, shared))
    assert float(want[:, 7, 0].min()) > 0.5 * m
    dis = ti.plain_disagreement(got, want)
    assert dis["n_in_equal"] and dis["rest_equal"], dis
    assert dis["gram"] <= 1e-5 and dis["d2s"] <= 1e-5, dis


@pytest.mark.cuda
def test_p2l_kernel_all_targets_masked_on_card(cuda_device, rng):
    args = list(_p2l_problem(rng, cuda_device, 2, 300, 777, True))
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
                                                    device=cuda_device))
    args = (q, torch.ones((200, 1), device=cuda_device)) + target + (
        torch.full((1, 1), 0.04, device=cuda_device),)
    got, want = _p2l_on_card(args)
    dis = ti.plain_disagreement(got, want)
    assert dis["n_in_equal"] and dis["gram"] <= 1e-5, dis
    assert float(got[0, 3, 3]) == 0.0 and float(got[0, 5, 5]) == 200.0
