"""Port vs JAX: FPFH features, feature matching and RANSAC registration of
the loop-closure path.

Both packages get the same cloud with the same normals.  FPFH bins pair
features with ``floor``: a pair feature within float32 round-off of a bin
edge can land in the other bin on one side.  So features agree to 1e-3
(relative, entries being histograms up to ~200) in every row that no pair
feature within 1e-5 of a bin edge touches; the other rows are counted and
must stay below 2%.  Matching and RANSAC then get the same (JAX's)
features.  Matching is an argmin over one matrix product: equal indices
outside near-ties.  RANSAC gets the JAX package's triplet draws: equal
inlier counts, transforms to 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.spatial.transform import Rotation

from open3d_slam_tpu.ops import fpfh as jfpfh, ransac as jransac
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.ops import fpfh as tfpfh, hashgrid as tgrid, normals as tnormals
from open3d_slam_torch.ops import ransac as transac, voxel as tvox
from open3d_slam_torch.utils import pointcloud as tpc

import reference_icp as ref

FEAT_RTOL = 1e-3
EDGE_EPS = 1e-5
MAX_EDGE_ROWS = 0.02
T_ATOL = 1e-4
RADIUS, MAX_NN = 2.5, 48


def make_scene(rng, n=2500):
    """Ground, walls and boxes (the scene of tests/test_fpfh_ransac.py)."""
    pts = ref.make_surface_scan(rng, n=n, extent=8.0)
    boxes = []
    for _ in range(6):
        cx, cy = rng.uniform(-6, 6, 2)
        w, h = rng.uniform(0.4, 1.2), rng.uniform(1.0, 3.0)
        m = n // 12
        face = rng.integers(0, 4, m)
        fx = np.where(face == 0, -w, np.where(face == 1, w, rng.uniform(-w, w, m)))
        fy = np.where(face == 2, -w, np.where(face == 3, w, rng.uniform(-w, w, m)))
        boxes.append(np.stack([cx + fx, cy + fy, rng.uniform(0, h, m)], axis=1))
    return np.concatenate([pts] + boxes).astype(np.float32)


def featurize(pts):
    """0.5 m voxel cloud (capacity 1024) with normals, FPFH in both packages."""
    down = tvox.voxel_downsample(tpc.from_numpy(pts), 0.5, out_capacity=1024)
    down = tnormals.estimate_normals(down, radius=1.0, max_nn=15)
    j = jpc.PointCloud(jnp.asarray(down.points.numpy()), jnp.asarray(down.mask.numpy()),
                       normals=jnp.asarray(down.normals.numpy()))
    return (j, jfpfh.compute_fpfh(j, RADIUS, max_nn=MAX_NN),
            down, tfpfh.compute_fpfh(down, RADIUS, max_nn=MAX_NN))


def _near_edge_rows(pc: tpc.PointCloud) -> np.ndarray:
    """Rows whose FPFH reads a pair feature within EDGE_EPS of a bin edge:
    its own pairs, or those of a neighbour whose SPFH it adds."""
    grid = tgrid.build(pc, RADIUS)
    idx, _, valid = tgrid.query_radius_bruteforce(grid, pc.points, RADIUS,
                                                  max_neighbors=MAX_NN)
    idx = idx.long()
    d64 = lambda a: a.double()  # noqa: E731
    f1, f2, f3, _, _ = tfpfh._pair_features(
        d64(pc.points)[:, None], d64(pc.normals)[:, None],
        d64(grid.points_sorted)[idx], d64(grid.normals_sorted)[idx])
    x = torch.stack([11 * (f1 + 1) / 2, 11 * (f2 + 1) / 2,
                     11 * (f3 + math.pi) / (2 * math.pi)], -1)
    edge = ((x - torch.round(x)).abs() < EDGE_EPS * 11 / 2).any(-1) & valid
    own = edge.any(1)
    own_slot = own[grid.order.long()]          # flag of the point in each slot
    return (own | (own_slot[idx] & valid).any(1)).numpy()


def test_compute_fpfh_matches_jax(rng):
    j, jf, t, tf = featurize(make_scene(rng))
    jf, tf = np.asarray(jf), tf.numpy()
    mask = t.mask.numpy()
    assert tf.shape == (1024, 33) and mask.sum() > 400
    assert (tf[~mask] == 0).all()
    bad = (np.abs(tf - jf) > FEAT_RTOL * np.maximum(np.abs(jf), 1.0)).any(1)
    near_edge = _near_edge_rows(t)
    assert not (bad & ~near_edge).any(), np.flatnonzero(bad & ~near_edge)
    assert bad.sum() <= MAX_EDGE_ROWS * mask.sum(), (bad.sum(), mask.sum())


def _view_pair(rng, T_gt):
    pts = make_scene(rng, n=3000)
    src_pts = ref.transform_pts(np.linalg.inv(T_gt), pts).astype(np.float32)
    return featurize(src_pts), featurize(pts)


def _T_gt():
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", 1.2).as_matrix()
    T[:3, 3] = [4.0, -3.0, 0.2]
    return T


def test_match_features_matches_jax(rng):
    """The same features on both sides (JAX's): equal indices wherever the
    two nearest features' exact distances differ by more than 1e-6 of
    |a|^2 + |b|^2, the size of the terms the expansion |a|^2 + |b|^2 - 2 a.b
    rounds (the two matrix products round differently)."""
    (js, jsf, ts, _), (jt, jtf, tt, _) = _view_pair(rng, _T_gt())
    fa, fb = np.array(jsf), np.array(jtf)
    ma, mb = ts.mask.numpy(), tt.mask.numpy()
    d2 = ((fa[:, None, :].astype(np.float64) - fb[None]) ** 2).sum(-1)
    d2 = np.where(mb[None, :], d2, np.inf)
    srt = np.sort(d2, 1)
    scale = (fa * fa).sum(1) + (fb * fb).sum(1).max()
    clear = ma & ((srt[:, 1] - srt[:, 0]) > 1e-6 * scale)
    assert clear.sum() > 0.95 * ma.sum()
    for mutual in (False, True):
        j_nn, j_ok = jfpfh.match_features(jsf, js.mask, jtf, jt.mask, mutual=mutual)
        t_nn, t_ok = tfpfh.match_features(torch.from_numpy(fa), ts.mask,
                                          torch.from_numpy(fb), tt.mask, mutual=mutual)
        j_nn, j_ok, t_nn, t_ok = (np.asarray(a) for a in (j_nn, j_ok, t_nn, t_ok))
        np.testing.assert_array_equal(t_nn[clear], j_nn[clear])
        np.testing.assert_array_equal(t_ok[clear], j_ok[clear])


def test_ransac_with_jax_draws_matches_jax(rng):
    """The same clouds, features (JAX's) and triplet draws on both sides."""
    T_gt = _T_gt()
    (js, jsf, ts, _), (jt, jtf, tt, _) = _view_pair(rng, T_gt)
    tsf, ttf = torch.from_numpy(np.array(jsf)), torch.from_numpy(np.array(jtf))
    key = jax.random.PRNGKey(3)
    n_hyp = 2048
    draws = torch.from_numpy(np.array(jax.random.randint(key, (n_hyp, 3), 0, 1 << 30)))
    j = jransac.ransac_feature_registration(
        js, jsf, jt, jtf, max_correspondence_distance=0.75, edge_length_similarity=0.9,
        distance_threshold=0.8, num_hypotheses=n_hyp, mutual_filter=True, key=key)
    t = transac.ransac_feature_registration(
        ts, tsf, tt, ttf, draws, max_correspondence_distance=0.75,
        edge_length_similarity=0.9, distance_threshold=0.8, mutual_filter=True)
    assert int(t.num_inliers) == int(j.num_inliers) > 25
    assert t.num_inliers.dtype == torch.int32
    np.testing.assert_allclose(t.transformation.numpy(), np.asarray(j.transformation),
                               atol=T_ATOL)
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(t.inlier_rmse), float(j.inlier_rmse), rtol=1e-4)
    # And both found the true motion's basin (the caller's ICP refines it).
    T = t.transformation.numpy()
    rot_err = np.arccos(np.clip((np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2, -1, 1))
    assert rot_err < np.radians(5) and np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 1.0
