"""Shared helpers of the port-vs-JAX parity tests (tests/test_torch_*.py).

On the CPU the JAX package routes around its Pallas kernels (hash-probe
normals, hash-grid NN, hash-sorted targets).  The port follows the kernel
path on every device, so the parity tests hold it against the JAX kernel
path: ``jax_kernel_path`` routes the JAX package's backend checks to "tpu",
runs its Pallas kernels (K1 to K4) in interpret mode and makes its
k-th-neighbour prepass exact.  Nothing of the JAX package is edited; the patches live only
inside the context.
"""
import contextlib
import dataclasses
import os

import jax
import numpy as np
import torch
from jax.experimental import pallas as pl

from open3d_slam_tpu.ops import pallas_gicp, pallas_icp, pallas_knn, pallas_normals
from open3d_slam_tpu.utils import config as jcfg
from open3d_slam_torch.utils import interop

# Under pytest-xdist each worker gets its share of the cores for torch's CPU
# operations.  With a thread per core in every worker, OpenMP's spinning
# barriers oversubscribe the machine: six workers on eight cores each ran
# the port's global localization of tests/test_torch_localization.py in
# 460 s instead of 12 s.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def _forcing(fn, **forced):
    def call(*args, **kwargs):
        return fn(*args, **{**kwargs, **forced})
    return call


class _InterpretedPallas:
    """``jax.experimental.pallas`` with ``pallas_call`` forced to interpret
    mode: ``pallas_knn.nn_argmin`` takes no ``interpret`` argument, so its
    module's ``pl`` is swapped for this inside ``jax_kernel_path``."""

    def __getattr__(self, name):
        return getattr(pl, name)

    pallas_call = staticmethod(_forcing(pl.pallas_call, interpret=True))


@contextlib.contextmanager
def jax_kernel_path():
    """Run the JAX package on its TPU kernel path, on the CPU."""
    patches = [
        (jax, "default_backend", lambda: "tpu"),
        (pallas_knn, "pl", _InterpretedPallas()),
        (pallas_gicp, "gicp_normal_eq",
         _forcing(pallas_gicp.gicp_normal_eq, interpret=True)),
        (pallas_icp, "p2l_normal_eq",
         _forcing(pallas_icp.p2l_normal_eq, interpret=True)),
        (pallas_normals, "radius_moments_at",
         _forcing(pallas_normals.radius_moments_at, interpret=True)),
        (pallas_normals, "radius_moments",
         _forcing(pallas_normals.radius_moments, interpret=True)),
        (pallas_normals, "kth_neighbor_d2_at",
         _forcing(pallas_normals.kth_neighbor_d2_at, exact=True)),
        (pallas_normals, "kth_neighbor_d2",
         _forcing(pallas_normals.kth_neighbor_d2, exact=True)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    # Traces made on the CPU route must not be reused under the patches.
    jax.clear_caches()
    try:
        for mod, name, new in patches:
            setattr(mod, name, new)
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
        jax.clear_caches()


class JaxScores:
    """The uniform downsample scores a JAX owner draws from ``PRNGKey(seed)``
    (split once per preprocess call), handed to the port's owner as its
    ``draw_scores``: torch cannot reproduce ``jax.random``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(sub, (n,))))


class JaxTriplets:
    """The RANSAC triplet draws of a JAX ``PlaceRecognition`` (its
    ``PRNGKey(7)``, split once per loop-closure job, then into one key per
    padded candidate, each drawing ``randint((H, 3), 0, 2^30)``), handed to
    the port's ``PlaceRecognition`` as its ``draw_triplets``."""

    def __init__(self, seed: int = 7):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, k_padded: int, n_hypotheses: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, k_padded)
        draws = [np.array(jax.random.randint(k, (n_hypotheses, 3), 0, 1 << 30))
                 for k in keys]
        return torch.from_numpy(np.stack(draws).astype(np.int64))


def small_jax_params(ratio: float = 1.0) -> jcfg.SlamParameters:
    """GICP for both registrations, loop closures and the dense map off, at
    small capacities (the shape of tests/test_async_and_regtypes.py)."""
    p = jcfg.SlamParameters()
    p.capacities.raw_scan = 4096
    p.capacities.processed_scan = 2048
    p.capacities.submap_points = 16384
    p.capacities.map_patch = 4096
    for o in (p.odometry, p.mapper):
        o.scan_processing.voxel_size = 0.4
        o.scan_processing.down_sampling_ratio = ratio
        o.scan_matcher.icp.max_correspondence_distance = 1.0
        o.scan_matcher.icp.max_num_iter = 12
        o.scan_matcher.icp.max_distance_knn = 1.2
        o.scan_matcher.icp.knn = 10
    p.odometry.scan_matcher.reg_type = "GeneralizedIcp"
    p.mapper.scan_matcher.scan_to_map_reg_type = "GeneralizedIcp"
    p.mapper.map_builder.map_voxel_size = 0.4
    p.mapper.is_build_dense_map = False
    p.mapper.is_attempt_loop_closures = False
    p.mapper.is_print_timing_statistics = False
    return p


def to_torch_params(p: jcfg.SlamParameters):
    return interop.params_from_dict(dataclasses.asdict(p))


def pose_errors(a: np.ndarray, b: np.ndarray):
    """(translation m, rotation rad) between two 4x4 poses."""
    d = np.linalg.inv(a) @ b
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(np.arccos(cos))
