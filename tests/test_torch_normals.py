"""Port vs JAX: kernel K2 (radius moments), the k-th-neighbour prepass and
normal estimation on the JAX package's kernel path (Pallas in interpret mode,
exact k-th neighbour).

Counts are exact: both test the same difference-form float32 distances
against the same radii.  Moment sums differ only in summation order (the
Pallas kernel multiplies a 0/1 matrix by the features, the plain version
too, in other blocks): 1e-5 relative, 1e-4 absolute on features of at most
a few square metres.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.ops import normals as jn, pallas_normals as jpn
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.ops import cuda_normals as tcn, normals as tn
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import jax_kernel_path


def _planes(rng, n_ground=320, n_wall=192, noise=0.005):
    ground = np.stack([rng.uniform(-4, 4, n_ground), rng.uniform(-4, 4, n_ground),
                       np.zeros(n_ground)], axis=1)
    wall = np.stack([np.full(n_wall, 2.0), rng.uniform(-4, 4, n_wall),
                     rng.uniform(0, 3, n_wall)], axis=1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    return pts + rng.normal(scale=noise, size=pts.shape).astype(np.float32)


def test_radius_moments_plain_matches_pallas(rng):
    n, m = 512, 256
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[480:] = False
    queries = pts[rng.choice(n, m, replace=False)]
    radius = rng.uniform(0.6, 1.4, m).astype(np.float32)
    want = np.asarray(jpn.radius_moments_at(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(radius), block_m=64, block_n=128, interpret=True))
    got = tcn.radius_moments_at(torch.from_numpy(queries), torch.from_numpy(pts),
                                torch.from_numpy(mask), torch.from_numpy(radius)).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # The scalar-radius form (a cloud against itself).
    want = np.asarray(jpn.radius_moments(jnp.asarray(pts), jnp.asarray(mask), 1.0,
                                         block_m=64, block_n=128, interpret=True))
    got = tcn.radius_moments(torch.from_numpy(pts), torch.from_numpy(mask), 1.0).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kth_neighbor_and_hybrid_radius_match_jax(rng):
    """Exact k-th neighbour in the expansion form: the two matmuls round
    alike up to an ulp of |q|^2 (~1e-6 at 3 m)."""
    n, m, k = 512, 128, 10
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    queries = pts[:m]
    want = np.asarray(jpn.kth_neighbor_d2_at(jnp.asarray(queries), jnp.asarray(pts),
                                             jnp.asarray(mask), k, exact=True))
    got = tcn.kth_neighbor_d2_at(torch.from_numpy(queries), torch.from_numpy(pts),
                                 torch.from_numpy(mask), k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        tcn.hybrid_radius(0.5, torch.from_numpy(want.copy())).numpy(),
        np.asarray(jpn.hybrid_radius(0.5, jnp.asarray(want))), rtol=1e-6)


def _prepass_case(rng, case):
    """(queries, support, mask, k, radius) of one prepass case, 10-20 m from
    the origin so that the expansion form's rounding shows."""
    if case == "ties":
        g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                                 indexing="ij"), -1).reshape(-1, 3) * 0.5
        pts = (g + np.float32([12.0, -3.0, 1.0])).astype(np.float32)
        return pts[rng.choice(len(pts), 96, replace=False)], pts, np.ones(len(pts), bool), 7, 1.2
    pts = (rng.uniform(-3, 3, (512, 3)) + np.float32([15.0, 8.0, -1.0])).astype(np.float32)
    mask = np.ones(512, bool)
    queries, k, radius = pts[:128], 10, 1.5
    if case == "sparse":          # few queries have k support points within r
        radius = 0.6
    if case == "k_above_valid":   # 6 valid points, k = 10: r^2 everywhere
        mask[6:] = False
    if case == "masked":
        mask = rng.uniform(size=512) < 0.7
    if case == "outside":         # queries that are not support points
        queries = (rng.uniform(-3.5, 3.5, (128, 3)) + np.float32([15.0, 8.0, -1.0])
                   ).astype(np.float32)
    return queries, pts, mask, k, radius


@pytest.mark.parametrize("case", ["sparse", "k_above_valid", "masked", "outside", "ties"])
def test_capped_prepass_matches_jax_exact_prepass(rng, case):
    """``kth_neighbor_d2_within`` (the prepass kernel's plain version)
    against the JAX package's exact prepass capped as ``hybrid_radius``
    caps it: both take the expansion form |q|^2 + |t|^2 - 2 q.t, whose dot
    both round as one FMA chain; the port sums the squared norms x, y, z,
    where XLA may sum them in another order, so the two agree to 4 ulps of
    |q|^2 + |t|^2 (and the radii to the square root of that)."""
    queries, pts, mask, k, radius = _prepass_case(rng, case)
    dk2 = np.asarray(jpn.kth_neighbor_d2_at(jnp.asarray(queries), jnp.asarray(pts),
                                            jnp.asarray(mask), k, exact=True))
    r2 = np.float32(radius) ** 2
    want = np.minimum(r2, dk2)
    got = tcn.kth_neighbor_d2_within(torch.from_numpy(queries), torch.from_numpy(pts),
                                     torch.from_numpy(mask), k, radius).numpy()
    scale = float((queries ** 2).sum(1).max() + (pts ** 2).sum(1).max())
    tol = 4 * np.finfo(np.float32).eps * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert got.max() <= r2 and got.min() >= 0.0
    np.testing.assert_allclose(
        tcn.hybrid_radius(radius, torch.from_numpy(got)).numpy(),
        np.asarray(jpn.hybrid_radius(radius, jnp.asarray(dk2))), rtol=0, atol=np.sqrt(tol))
    capped = dk2 > r2 + tol
    assert np.array_equal(got[capped], np.full(int(capped.sum()), r2, np.float32))
    if case in ("sparse", "k_above_valid"):
        assert capped.mean() > (0.99 if case == "k_above_valid" else 0.2)
    if case == "ties":
        assert np.array_equal(got, want)


def test_smallest_eigvec_and_covariances_match_jax(rng):
    """Well-conditioned covariances (smallest eigenvalue separated by 1e-2):
    the eigenvector agrees to 1e-4, up to sign."""
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    Q, _ = np.linalg.qr(A)
    ev = np.stack([rng.uniform(0.5, 1.0, 64), rng.uniform(0.1, 0.3, 64),
                   rng.uniform(0.0, 0.05, 64)], 1)
    C = (Q * ev[:, None, :]) @ np.transpose(Q, (0, 2, 1))
    C = C.astype(np.float32)
    want = np.asarray(jn.smallest_eigvec_sym3(jnp.asarray(C)))
    got = tn.smallest_eigvec_sym3(torch.from_numpy(C)).numpy()
    np.testing.assert_allclose(np.abs((got * want).sum(1)), 1.0, atol=1e-4)
    nrm = want / np.linalg.norm(want, axis=1, keepdims=True)
    jpc_ = jpc.PointCloud(jnp.zeros((64, 3)), jnp.ones(64, bool), normals=jnp.asarray(nrm))
    tpc_ = tpc.PointCloud(torch.zeros(64, 3), torch.ones(64, dtype=torch.bool),
                          normals=torch.from_numpy(nrm.astype(np.float32)))
    np.testing.assert_allclose(tn.covariances_from_normals(tpc_).numpy(),
                               np.asarray(jn.covariances_from_normals(jpc_)), atol=1e-6)


@pytest.mark.parametrize("subset", [False, True])
def test_estimate_normals_match_jax_flash(rng, subset):
    """``estimate_normals`` (a cloud against itself) and ``estimate_normals_at``
    (a query subset against the full support), hybrid radius + k.  A normal
    of a neighbourhood whose two smallest eigenvalues nearly tie is
    ill-posed, so the test asks 99% of normals to agree to 1e-3 (|dot|).
    Counts are held exactly by the moments test above."""
    pts = _planes(rng)
    n = pts.shape[0]
    support_j, support_t = jpc.from_numpy(pts, capacity=n), tpc.from_numpy(pts, capacity=n)
    sel = np.sort(rng.choice(n, 128, replace=False))
    with jax_kernel_path():
        if subset:
            q_j = jpc.from_numpy(pts[sel], capacity=128)
            want = jn.estimate_normals_at(q_j, support_j, 0.8, max_nn=12,
                                          method="flash", interpret=True)
        else:
            want = jn.estimate_normals(support_j, 0.8, max_nn=12, method="flash",
                                       interpret=True)
    if subset:
        got = tn.estimate_normals_at(tpc.from_numpy(pts[sel], capacity=128),
                                     support_t, 0.8, max_nn=12)
    else:
        got = tn.estimate_normals(support_t, 0.8, max_nn=12)
    dots = np.abs(np.sum(got.normals.numpy() * np.asarray(want.normals), axis=1))
    assert np.mean(dots > 0.999) >= 0.99, np.sort(dots)[:8]
    # Oriented toward the origin, as the JAX package orients them.
    facing = np.sum(got.normals.numpy() * -got.points.numpy(), axis=1)
    assert np.all(facing >= 0.0)

