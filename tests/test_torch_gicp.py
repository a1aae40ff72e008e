"""Port vs JAX: kernel K1 (fused GICP normal equations), its helpers, and the
fused Gauss-Newton registration loop, on the JAX kernel path (Pallas in
interpret mode).  Also the two rules on the port's kernel wrappers: a CUDA
tensor goes to the hand-written kernel or raises, and the launch path calls
no library kernel.

The inlier count is exact (same difference-form float32 distances, same
lowest-index tie break).  The 7x7 Gram is a sum over a few hundred
whitened rows taken in another order: 1e-5 of its largest entry.
"""
import ast
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.ops import normals as jn, pallas_gicp as jg, pallas_icp
from open3d_slam_tpu.ops import registration as jreg
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.ops import cuda_build, cuda_gicp as tg, cuda_gn_step, cuda_normals
from open3d_slam_torch.ops import registration as treg
from open3d_slam_torch.ops.hashgrid import HashGrid
from open3d_slam_torch.utils import pointcloud as tpc

REL = 1e-5


def _scene(rng, n_tgt=512, n_src=128, offset=(0.08, -0.05, 0.02)):
    half = n_tgt // 2
    ground = np.stack([rng.uniform(-5, 5, half), rng.uniform(-5, 5, half),
                       0.01 * rng.standard_normal(half)], axis=1)
    wall = np.stack([rng.uniform(-5, 5, n_tgt - half),
                     5.0 + 0.01 * rng.standard_normal(n_tgt - half),
                     rng.uniform(0, 3, n_tgt - half)], axis=1)
    tgt = np.concatenate([ground, wall]).astype(np.float32)
    tgt = tgt[np.lexsort((tgt[:, 2], tgt[:, 1], tgt[:, 0]))]   # spatially sorted
    src = tgt[rng.choice(n_tgt, n_src, replace=False)] + np.asarray(offset, np.float32)
    return src, tgt


@pytest.fixture
def problem(rng):
    """Source and target with GICP covariances from the JAX normals; the
    target carries padding rows, the source some invalid ones."""
    src, tgt = _scene(rng)
    tgt_pc = jn.estimate_normals(jpc.from_numpy(tgt, capacity=512), 0.8, max_nn=12)
    src_pc = jn.estimate_normals(jpc.from_numpy(src, capacity=128), 0.8, max_nn=12)
    tmask = np.ones(512, bool)
    tmask[500:] = False
    smask = np.ones(128, bool)
    smask[120:] = False
    return dict(
        src=np.array(src_pc.points), smask=smask,
        src_cov=np.array(jn.covariances_from_normals(src_pc)),
        tgt=np.array(tgt_pc.points), tmask=tmask,
        tgt_cov=np.array(jn.covariances_from_normals(tgt_pc)))


def _jax_inputs(pb):
    td, tv = jg.prepare_target(jnp.asarray(pb["tgt"]), jnp.asarray(pb["tgt_cov"]),
                               jnp.asarray(pb["tmask"]))
    return (jnp.asarray(pb["src"])[None],
            jnp.asarray(pb["smask"], jnp.float32)[:, None],
            jg.cov6_from_full(jnp.asarray(pb["src_cov"]))[None], td, tv)


def _torch_inputs(pb):
    T = lambda a: torch.from_numpy(np.array(a))
    td, tv, _ = tg.prepare_target(T(pb["tgt"]), T(pb["tgt_cov"]), T(pb["tmask"]))
    return (T(pb["src"])[None], T(pb["smask"]).to(torch.float32)[:, None],
            tg.cov6_from_full(T(pb["src_cov"]))[None], td, tv)


def test_prepare_target_and_tile_aabbs_match_jax(problem):
    jtd, jtv = _jax_inputs(problem)[3:]
    ttd, ttv = _torch_inputs(problem)[3:]
    np.testing.assert_array_equal(ttd.numpy(), np.asarray(jtd))
    np.testing.assert_array_equal(ttv.numpy(), np.asarray(jtv))
    for block in (128, 256):
        want = jg.tile_aabbs(jnp.asarray(problem["tgt"]), jnp.asarray(problem["tmask"]), block)
        got = tg.tile_aabbs(torch.from_numpy(problem["tgt"]),
                            torch.from_numpy(problem["tmask"]), block)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_aabb", [False, True])
def test_gicp_normal_eq_plain_matches_pallas(problem, with_aabb):
    r2 = 0.25
    jin = _jax_inputs(problem)
    tin = _torch_inputs(problem)
    j_aabb = (jg.tile_aabbs(jnp.asarray(problem["tgt"]), jnp.asarray(problem["tmask"]), 128)
              if with_aabb else None)
    t_aabb = (tg.tile_aabbs(torch.from_numpy(problem["tgt"]),
                            torch.from_numpy(problem["tmask"]), 128) if with_aabb else None)
    want = np.asarray(jg.gicp_normal_eq(*jin, jnp.full((1, 1), r2, jnp.float32),
                                        t_aabb=j_aabb, block_m=64, block_n=128,
                                        interpret=True))
    got = tg.gicp_normal_eq(*tin, torch.full((1, 1), r2), t_aabb).numpy()
    assert got[0, 7, 0] == want[0, 7, 0] > 100         # inlier count, exact
    np.testing.assert_allclose(got[0, 7, 1], want[0, 7, 1], rtol=REL)
    np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max())
    JtJ, Jtr, n_in, d2s = tg.unpack(torch.from_numpy(got))
    wJtJ, wJtr, wn, wd = pallas_icp.unpack(jnp.asarray(got))
    np.testing.assert_array_equal(JtJ.numpy(), np.asarray(wJtJ))
    np.testing.assert_array_equal(Jtr.numpy(), np.asarray(wJtr))


def test_rotate_cov6_matches_jax(problem, rng):
    from open3d_slam_tpu.utils import se3 as jse3
    R = np.array(jse3.se3_exp(jnp.asarray([0.3, -0.2, 0.5, 0, 0, 0], jnp.float32)))[:3, :3]
    cov6 = jg.cov6_from_full(jnp.asarray(problem["src_cov"]))
    want = np.asarray(jg.rotate_cov6(jnp.asarray(R), cov6))
    got = tg.rotate_cov6(torch.from_numpy(R), torch.from_numpy(np.array(cov6))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_icp_generalized_matches_jax_fused_loop(problem):
    """The fused Gauss-Newton loop: transform, fitness, rmse and iteration
    count against the JAX loop around the interpreted Pallas kernel.  The
    poses agree to 1e-5 (float32 steps from Grams that differ in
    summation order); the iteration counts exactly."""
    jin = _jax_inputs(problem)
    n_src = float(problem["smask"].sum())
    want = jreg._icp_gicp_fused_batch(
        *jin[:2], jnp.float32(n_src), jin[2], *jin[3:], jnp.eye(4)[None], 0.5, 30,
        1e-6, 1e-6, None, 64, 128, interpret=True)
    tmask = torch.from_numpy(problem["tmask"])
    grid = HashGrid(
        hashes_sorted=torch.where(tmask, 0, treg.INT32_MAX).to(torch.int32),
        points_sorted=torch.from_numpy(problem["tgt"]), normals_sorted=None,
        order=torch.arange(512, dtype=torch.int32), cell_size=0.5)
    src = tpc.PointCloud(torch.from_numpy(problem["src"]),
                         torch.from_numpy(problem["smask"]))
    got = treg.icp_generalized(src, torch.from_numpy(problem["src_cov"]), grid,
                               torch.from_numpy(problem["tgt_cov"]), torch.eye(4),
                               0.5, max_iterations=30)
    T = got.transformation.numpy()
    np.testing.assert_allclose(T, np.asarray(want.transformation[0]), atol=1e-5)
    np.testing.assert_allclose(T[:3, 3], [-0.08, 0.05, -0.02], atol=0.02)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse[0]),
                               rtol=1e-4)
    assert int(got.num_iterations) == int(want.num_iterations[0])


def test_solve6_matches_jax(rng):
    A = rng.normal(size=(6, 6)).astype(np.float32)
    JtJ = A @ A.T + np.eye(6, dtype=np.float32)
    Jtr = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jreg._solve6(jnp.asarray(JtJ), jnp.asarray(Jtr)))
    got = cuda_gn_step.solve6_chain(torch.from_numpy(JtJ)[None],
                                    torch.from_numpy(Jtr)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


# --- the wrapper rules -----------------------------------------------------

_LAUNCHERS = [(tg, "_launch_gicp"), (cuda_normals, "_launch_moments")]
_WRAPPERS = [(tg, "gicp_normal_eq"), (cuda_normals, "radius_moments_at")]
# What a launch path may call of torch: output/scratch allocation and the
# current stream / device properties.
_ALLOWED = {"torch.empty", "torch.zeros", "torch.cuda.current_stream",
            "torch.cuda.get_device_properties"}


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@pytest.mark.parametrize("mod,name", _LAUNCHERS)
def test_launch_paths_call_no_library_kernel(mod, name):
    tree = ast.parse(inspect.getsource(getattr(mod, name)))
    calls = {_dotted(n.func) for n in ast.walk(tree) if isinstance(n, ast.Call)}
    torch_calls = {c for c in calls if c.startswith("torch.")}
    assert torch_calls <= _ALLOWED, torch_calls - _ALLOWED
    assert not any("compile" in c or "cdist" in c or "matmul" in c for c in calls)
    assert any(c.startswith("fn") or c.startswith("lib.") for c in calls)


@pytest.mark.parametrize("mod,name", _WRAPPERS)
def test_wrappers_have_no_fallback(mod, name):
    """No ``try`` in a wrapper: a CUDA tensor launches the kernel or raises."""
    tree = ast.parse(inspect.getsource(getattr(mod, name)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_wrappers_raise_off_cpu_without_a_kernel():
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError):
        tg.gicp_normal_eq(torch.empty(1, 256, 3, **meta), torch.empty(256, 1, **meta),
                          torch.empty(1, 256, 6, **meta), torch.empty(9, 256, **meta),
                          torch.empty(1, 256, **meta), torch.empty(1, 1, **meta))
    with pytest.raises(RuntimeError):
        cuda_normals.radius_moments_at(torch.empty(8, 3, **meta), torch.empty(8, 3, **meta),
                                       torch.empty(8, dtype=torch.bool, device="meta"),
                                       1.0)


def test_failed_launch_raises():
    cuda_build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 700"):
        cuda_build.check(700, "gicp_normal_eq")

