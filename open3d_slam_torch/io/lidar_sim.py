"""High-fidelity spinning-beam LiDAR simulator.

The environment has **no downloadable real datasets** (zero egress), so the
real-data validation demanded by the reference docs
(``documentation/source/usage.rst:97-98``, ``examples.rst:7-36`` replay real
rosbags / KITTI) is stood in for by this simulator, which reproduces the
physics the pipeline actually depends on — unlike the uniform surface
subsampling in :mod:`open3d_slam_torch.io.datasets`:

* **Beam pattern**: real sensor channel tables (VLP-16, HDL-64E, OS0-128
  class) — fixed elevation rings x a uniform azimuth sweep, so point density
  falls off with range and normals/FPFH see real LiDAR anisotropy.
* **Occlusion**: exact analytic ray casting against a primitive world
  (bounded planes, axis-aligned boxes, vertical cylinders); each ray returns
  the FIRST hit only, so revisits see view-dependent overlap like a real bag.
* **Rolling shutter**: each azimuth column is cast from the sensor pose at
  its spin phase, and the point is stored in that *instantaneous* sensor
  frame (exactly what a raw driver emits); a moving sensor therefore produces
  the skewed clouds that ``ConstantVelocityMotionCompensation``
  (``src/MotionCompensation.cpp:64-118``) exists to fix.  The scan timestamp
  is the sweep START, matching the reference's phase-0 convention.
* **Range noise + dropout**: per-ray Gaussian range error and Bernoulli
  dropout (absorbing/spec surfaces, max-range misses).

Everything here is host-side NumPy dataset generation — the TPU compute path
never runs this code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from open3d_slam_torch.io.datasets import SyntheticSequence

# ---------------------------------------------------------------------------
# Sensor beam models (public spec sheets; elevations in degrees)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BeamModel:
    name: str
    elevations_deg: Tuple[float, ...]   # one per ring
    azimuth_steps: int                  # columns per revolution at 10 Hz
    max_range: float
    min_range: float
    range_noise_std: float              # 1-sigma range error [m]
    dropout: float                      # per-ray Bernoulli drop probability


def _lin(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    return tuple(np.linspace(lo, hi, n).tolist())


# VLP-16: 16 rings, +/-15 deg, 0.2 deg azimuth @10 Hz -> 1800 cols.
VLP16 = BeamModel("vlp16", _lin(-15.0, 15.0, 16), 1800, 100.0, 0.9, 0.02, 0.05)
# HDL-64E: 64 rings, +2 .. -24.8 deg, ~0.17 deg azimuth -> use 2048 cols.
HDL64 = BeamModel("hdl64", _lin(2.0, -24.8, 64), 2048, 120.0, 0.9, 0.02, 0.05)
# OS0-128 class: 128 rings, +/-45 deg, 1024 cols, short range.
OS0_128 = BeamModel("os0_128", _lin(45.0, -45.0, 128), 1024, 50.0, 0.3, 0.03, 0.08)

SENSORS = {m.name: m for m in (VLP16, HDL64, OS0_128)}


# ---------------------------------------------------------------------------
# Analytic primitives: vectorized ray casting.  Rays: origins (M,3),
# unit dirs (M,3) in WORLD frame; each primitive returns hit distance t
# (M,), +inf where missed.
# ---------------------------------------------------------------------------


class Primitive:
    def raycast(self, o: np.ndarray, d: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sdf(self, p: np.ndarray) -> np.ndarray:
        """Unsigned distance from points (M,3) to the primitive surface
        (used by tests to verify hit points lie ON world geometry)."""
        raise NotImplementedError


class GroundPlane(Primitive):
    """z = z0 over |x|,|y| <= extent."""

    def __init__(self, extent: float, z0: float = 0.0):
        self.extent, self.z0 = float(extent), float(z0)

    def raycast(self, o, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (self.z0 - o[:, 2]) / d[:, 2]
        p = o + t[:, None] * d
        ok = (t > 0) & np.isfinite(t) & \
            (np.abs(p[:, 0]) <= self.extent) & (np.abs(p[:, 1]) <= self.extent)
        return np.where(ok, t, np.inf)

    def sdf(self, p):
        dz = np.abs(p[:, 2] - self.z0)
        ox = np.maximum(np.abs(p[:, 0]) - self.extent, 0.0)
        oy = np.maximum(np.abs(p[:, 1]) - self.extent, 0.0)
        return np.sqrt(dz * dz + ox * ox + oy * oy)


class Box(Primitive):
    """Axis-aligned box [lo, hi] (buildings, walls, crates)."""

    def __init__(self, lo: Sequence[float], hi: Sequence[float]):
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)

    def raycast(self, o, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
        t1 = (self.lo[None] - o) * inv
        t2 = (self.hi[None] - o) * inv
        tmin = np.minimum(t1, t2).max(axis=1)
        tmax = np.maximum(t1, t2).min(axis=1)
        # Entry hit only (rays starting inside see the exit face; that is
        # fine — a sensor inside a box is a degenerate scene).
        ok = (tmax >= tmin) & (tmax > 0)
        t = np.where(tmin > 0, tmin, tmax)
        return np.where(ok, t, np.inf)

    def sdf(self, p):
        c = (self.lo + self.hi) / 2
        h = (self.hi - self.lo) / 2
        q = np.abs(p - c[None]) - h[None]
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
        inside = np.minimum(q.max(axis=1), 0.0)
        return np.abs(outside + inside)


class VerticalCylinder(Primitive):
    """Infinite-thin pole/tree trunk: axis z through (cx, cy), z in [z0, z1]."""

    def __init__(self, cx: float, cy: float, radius: float,
                 z0: float = 0.0, z1: float = 5.0):
        self.c = np.array([cx, cy], np.float64)
        self.r, self.z0, self.z1 = float(radius), float(z0), float(z1)

    def raycast(self, o, d):
        oc = o[:, :2] - self.c[None]
        a = (d[:, :2] ** 2).sum(axis=1)
        b = 2.0 * (oc * d[:, :2]).sum(axis=1)
        c = (oc ** 2).sum(axis=1) - self.r ** 2
        disc = b * b - 4 * a * c
        with np.errstate(divide="ignore", invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-b - sq) / (2 * a)       # near intersection
        z = o[:, 2] + t * d[:, 2]
        ok = (disc > 0) & (a > 1e-12) & (t > 0) & (z >= self.z0) & (z <= self.z1)
        return np.where(ok, t, np.inf)

    def sdf(self, p):
        dr = np.abs(np.linalg.norm(p[:, :2] - self.c[None], axis=1) - self.r)
        dz = np.maximum(np.maximum(self.z0 - p[:, 2], p[:, 2] - self.z1), 0.0)
        return np.sqrt(dr * dr + dz * dz)


class PrimitiveWorld:
    def __init__(self, primitives: List[Primitive]):
        self.primitives = primitives

    def raycast(self, o: np.ndarray, d: np.ndarray) -> np.ndarray:
        """First-hit distance per ray; +inf where nothing is hit."""
        t = np.full(len(o), np.inf)
        for prim in self.primitives:
            t = np.minimum(t, prim.raycast(o, d))
        return t

    def surface_distance(self, p: np.ndarray) -> np.ndarray:
        d = np.full(len(p), np.inf)
        for prim in self.primitives:
            d = np.minimum(d, prim.sdf(p))
        return d


# ---------------------------------------------------------------------------
# World presets
# ---------------------------------------------------------------------------


def make_yard_world(extent: float = 40.0, n_buildings: int = 10,
                    n_poles: int = 24, seed: int = 0,
                    keep_clear: Optional[np.ndarray] = None,
                    clear_radius: float = 3.0) -> PrimitiveWorld:
    """Walled yard: ground + 4 boundary walls + random buildings + poles.

    ``keep_clear``: (K, 2) xy points (e.g. the trajectory) that primitive
    footprints must stay ``clear_radius`` away from.
    """
    rng = np.random.default_rng(seed)
    e = extent
    prims: List[Primitive] = [GroundPlane(e)]
    wall_h, wall_t = 4.0, 0.3
    prims += [
        Box([-e, e - wall_t, 0], [e, e, wall_h]),
        Box([-e, -e, 0], [e, -e + wall_t, wall_h]),
        Box([e - wall_t, -e, 0], [e, e, wall_h]),
        Box([-e, -e, 0], [-e + wall_t, e, wall_h]),
    ]

    def clear(cx, cy, rad):
        if keep_clear is None or len(keep_clear) == 0:
            return True
        dd = np.linalg.norm(keep_clear - np.array([cx, cy]), axis=1)
        return bool((dd > rad + clear_radius).all())

    made = 0
    for _ in range(200):
        if made >= n_buildings:
            break
        cx, cy = rng.uniform(-0.85 * e, 0.85 * e, 2)
        wx, wy = rng.uniform(1.5, 6.0, 2)
        h = rng.uniform(2.5, 8.0)
        if clear(cx, cy, max(wx, wy)):
            prims.append(Box([cx - wx, cy - wy, 0], [cx + wx, cy + wy, h]))
            made += 1
    made = 0
    for _ in range(400):
        if made >= n_poles:
            break
        cx, cy = rng.uniform(-0.9 * e, 0.9 * e, 2)
        r = rng.uniform(0.08, 0.35)
        h = rng.uniform(2.0, 6.0)
        if clear(cx, cy, r):
            prims.append(VerticalCylinder(cx, cy, r, 0.0, h))
            made += 1
    return PrimitiveWorld(prims)


def make_corridor_world(length: float = 60.0, width: float = 6.0,
                        n_crates: int = 16, seed: int = 1) -> PrimitiveWorld:
    """Indoor corridor along +x with side walls, ceiling, and crates."""
    rng = np.random.default_rng(seed)
    h, t = 3.0, 0.2
    prims: List[Primitive] = [
        GroundPlane(length + 5.0),
        Box([-2, width / 2, 0], [length + 2, width / 2 + t, h]),
        Box([-2, -width / 2 - t, 0], [length + 2, -width / 2, h]),
        Box([-2, -width / 2 - t, h], [length + 2, width / 2 + t, h + t]),  # ceiling
        Box([length + 2, -width / 2, 0], [length + 2 + t, width / 2, h]),  # end wall
        Box([-2 - t, -width / 2, 0], [-2, width / 2, h]),                  # start wall
    ]
    for _ in range(n_crates):
        cx = rng.uniform(2.0, length - 2.0)
        side = rng.choice([-1.0, 1.0])
        cy = side * rng.uniform(width / 2 - 1.3, width / 2 - 0.6)
        w = rng.uniform(0.25, 0.6)
        prims.append(Box([cx - w, cy - w, 0], [cx + w, cy + w, rng.uniform(0.5, 1.6)]))
    return PrimitiveWorld(prims)


# ---------------------------------------------------------------------------
# Continuous trajectories: pose(t) -> 4x4 (vectorized over t)
# ---------------------------------------------------------------------------


def _yaw_poses(x: np.ndarray, y: np.ndarray, z: np.ndarray,
               yaw: np.ndarray, pitch: Optional[np.ndarray] = None) -> np.ndarray:
    """Stack (T,) coordinate arrays into (T,4,4) z-up poses (yaw then pitch)."""
    T = len(x)
    cy, sy = np.cos(yaw), np.sin(yaw)
    out = np.tile(np.eye(4), (T, 1, 1))
    Rz = np.zeros((T, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1] = cy, -sy
    Rz[:, 1, 0], Rz[:, 1, 1] = sy, cy
    Rz[:, 2, 2] = 1.0
    if pitch is not None:
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.zeros((T, 3, 3))
        Ry[:, 0, 0], Ry[:, 0, 2] = cp, sp
        Ry[:, 1, 1] = 1.0
        Ry[:, 2, 0], Ry[:, 2, 2] = -sp, cp
        Rz = np.einsum("tij,tjk->tik", Rz, Ry)
    out[:, :3, :3] = Rz
    out[:, 0, 3], out[:, 1, 3], out[:, 2, 3] = x, y, z
    return out


class Trajectory:
    """Analytic continuous trajectory; ``poses(t)`` is vectorized so a whole
    sweep's column poses come from one call."""

    def poses(self, t: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def pose(self, t: float) -> np.ndarray:
        return self.poses(np.array([t]))[0]


class CircleTrajectory(Trajectory):
    def __init__(self, radius: float = 14.0, period: float = 60.0,
                 z: float = 1.2, bounce: float = 0.0):
        self.radius, self.period, self.z, self.bounce = radius, period, z, bounce

    def poses(self, t):
        t = np.asarray(t, np.float64)
        a = 2 * np.pi * t / self.period
        x, y = self.radius * np.cos(a), self.radius * np.sin(a)
        z = self.z + self.bounce * np.sin(2 * np.pi * t * 2.0)   # 2 Hz gait bob
        yaw = a + np.pi / 2
        pitch = (0.05 * self.bounce / max(self.bounce, 1e-9)) * \
            np.sin(2 * np.pi * t * 2.0 + 1.0) if self.bounce > 0 else None
        return _yaw_poses(x, y, z, yaw, pitch)


class LemniscateTrajectory(Trajectory):
    """Figure-8 (Gerono lemniscate): two loops, both turning directions —
    a stress test for odometry and a natural double-revisit for loop closure."""

    def __init__(self, a: float = 16.0, period: float = 90.0, z: float = 1.2):
        self.a, self.period, self.z = a, period, z

    def poses(self, t):
        t = np.asarray(t, np.float64)
        s = 2 * np.pi * t / self.period
        x = self.a * np.sin(s)
        y = self.a * np.sin(s) * np.cos(s)
        dx = self.a * np.cos(s)
        dy = self.a * np.cos(2 * s)
        yaw = np.arctan2(dy, dx)
        return _yaw_poses(x, y, np.full_like(x, self.z), yaw)


class StraightTrajectory(Trajectory):
    def __init__(self, speed: float = 1.5, z: float = 1.2, y: float = 0.0):
        self.speed, self.z, self.y = speed, z, y

    def poses(self, t):
        t = np.asarray(t, np.float64)
        x = self.speed * t
        return _yaw_poses(x, np.full_like(x, self.y), np.full_like(x, self.z),
                          np.zeros_like(x))


# ---------------------------------------------------------------------------
# Sweep rendering
# ---------------------------------------------------------------------------


def render_sweep(world: PrimitiveWorld, traj: Trajectory, t0: float,
                 beam: BeamModel = VLP16, scan_duration: float = 0.1,
                 spin_clockwise: bool = True,
                 rng: Optional[np.random.Generator] = None,
                 return_meta: bool = False):
    """Render one full revolution starting at ``t0``.

    Returns (N, 3) float32 points in the raw (distorted) sensor frame — each
    azimuth column is expressed in the sensor frame at ITS OWN measurement
    time, concatenated as one cloud, exactly like a raw LiDAR driver packet
    assembly.  With ``return_meta`` also returns per-point (time offset [s],
    ring id) arrays.
    """
    rng = rng or np.random.default_rng(0)
    K, B = beam.azimuth_steps, len(beam.elevations_deg)
    phase = (np.arange(K) + 0.5) / K                       # (K,)
    # compute_phase inverse: CW sensors sweep azimuth 2pi -> 0, CCW 0 -> 2pi
    # (ops/motion_compensation.py:26-33 semantics).
    azim = 2 * np.pi * (1.0 - phase) if spin_clockwise else 2 * np.pi * phase
    elev = np.deg2rad(np.asarray(beam.elevations_deg))     # (B,)

    # Sensor-frame ray directions per (column, ring).
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    dirs = np.stack([ca[:, None] * ce[None, :],
                     sa[:, None] * ce[None, :],
                     np.broadcast_to(se[None, :], (K, B))], axis=-1)  # (K,B,3)

    Ts = traj.poses(t0 + phase * scan_duration)            # (K,4,4)
    o_w = np.repeat(Ts[:, :3, 3], B, axis=0)               # (K*B,3)
    d_w = np.einsum("kij,kbj->kbi", Ts[:, :3, :3], dirs).reshape(-1, 3)

    t_hit = world.raycast(o_w, d_w)                        # (K*B,)
    r = t_hit + rng.normal(scale=beam.range_noise_std, size=t_hit.shape)
    valid = np.isfinite(t_hit) & (r > beam.min_range) & (r < beam.max_range) \
        & (rng.random(t_hit.shape) > beam.dropout)

    pts = (r[:, None] * dirs.reshape(-1, 3))[valid].astype(np.float32)
    if not return_meta:
        return pts
    t_off = np.repeat(phase * scan_duration, B)[valid].astype(np.float32)
    ring = np.tile(np.arange(B), K)[valid].astype(np.int32)
    return pts, t_off, ring


@dataclasses.dataclass
class SimSequenceSpec:
    """One named, fully reproducible simulated dataset."""
    name: str
    sensor: str = "vlp16"
    world: str = "yard"               # yard | corridor
    trajectory: str = "circle"        # circle | figure8 | straight
    n_scans: int = 120
    rate_hz: float = 10.0
    seed: int = 0
    world_kwargs: dict = dataclasses.field(default_factory=dict)
    traj_kwargs: dict = dataclasses.field(default_factory=dict)
    param_file: str = "velodyne_puck16.yaml"  # default sensor config (configs/)


_MAX_DEFAULT_SPEED = 3.5  # m/s — walking-robot class; see BENCHMARK_SEQUENCES


def _build_trajectory(spec: SimSequenceSpec) -> Trajectory:
    """Trajectory for a spec.  Default period covers ~1.05 revolutions over
    the sequence — the loop-closure design of the long named sequences —
    but is FLOORED so the default platform speed never exceeds
    ``_MAX_DEFAULT_SPEED``: a short ad-hoc spec (e.g. a 40-scan bench
    render) would otherwise get a physically absurd 20+ m/s robot whose
    inter-scan motion exceeds every ICP correspondence radius, producing
    fitness-0.000 "dropouts" that look like pipeline bugs.  Explicit
    ``traj_kwargs['period']`` always wins."""
    dur = spec.n_scans / spec.rate_hz
    if spec.trajectory == "circle":
        radius = spec.traj_kwargs.get("radius", 14.0)
        min_period = 2 * np.pi * radius / _MAX_DEFAULT_SPEED
        kw = dict(radius=radius, period=max(dur / 1.05, min_period), z=1.2)
        kw.update(spec.traj_kwargs)
        return CircleTrajectory(**kw)
    if spec.trajectory == "figure8":
        a = spec.traj_kwargs.get("a", 16.0)
        min_period = 6.1 * a / _MAX_DEFAULT_SPEED   # lemniscate length ~6.1a
        kw = dict(a=a, period=max(dur / 1.02, min_period), z=1.2)
        kw.update(spec.traj_kwargs)
        return LemniscateTrajectory(**kw)
    if spec.trajectory == "straight":
        kw = dict(speed=1.5, z=1.2)
        kw.update(spec.traj_kwargs)
        return StraightTrajectory(**kw)
    raise ValueError(spec.trajectory)


def _build_world(spec: SimSequenceSpec, traj: Trajectory) -> PrimitiveWorld:
    dur = spec.n_scans / spec.rate_hz
    clear = traj.poses(np.linspace(0, dur, 256))[:, :2, 3]
    if spec.world == "yard":
        kw = dict(extent=40.0, seed=spec.seed)
        kw.update(spec.world_kwargs)
        return make_yard_world(keep_clear=clear, **kw)
    if spec.world == "corridor":
        kw = dict(seed=spec.seed)
        kw.update(spec.world_kwargs)
        return make_corridor_world(**kw)
    raise ValueError(spec.world)


def _spec_cache_key(spec: SimSequenceSpec, spin_clockwise: bool) -> str:
    import hashlib
    blob = repr((dataclasses.astuple(spec), spin_clockwise, "v2"))
    return f"{spec.name}_{hashlib.sha1(blob.encode()).hexdigest()[:12]}"


def make_sim_sequence(spec: SimSequenceSpec,
                      spin_clockwise: bool = True,
                      cache_dir: Optional[str] = None) -> SyntheticSequence:
    """Render a full simulated dataset: raw distorted scans + ground-truth
    poses at each sweep START (the reference's phase-0 stamp convention).

    Rendering a long sequence costs minutes of host CPU; rendered sequences
    are cached on disk (``cache_dir``, default ``$O3D_SIM_CACHE`` or
    ``~/.cache/o3d_slam_tpu_sim``) keyed by the full spec, so benchmark and
    evaluation reruns skip the render.  Pass ``cache_dir=""`` to disable.
    """
    import os
    if cache_dir is None:
        cache_dir = os.environ.get(
            "O3D_SIM_CACHE",
            os.path.join(os.path.expanduser("~"), ".cache", "o3d_slam_tpu_sim"))
    cache_path = None
    if cache_dir:
        cache_path = os.path.join(
            cache_dir, _spec_cache_key(spec, spin_clockwise) + ".npz")
        if os.path.exists(cache_path):
            try:
                z = np.load(cache_path)
                offs = z["offsets"]
                pts = z["points"]
                scans = [pts[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
                gt = [z["gt"][i] for i in range(z["gt"].shape[0])]
                return SyntheticSequence(scans=scans,
                                         timestamps=list(z["ts"]),
                                         ground_truth=gt)
            except Exception as e:   # corrupt cache -> re-render
                print(f"[lidar_sim] cache read failed ({e}); re-rendering")

    traj = _build_trajectory(spec)
    world = _build_world(spec, traj)
    beam = SENSORS[spec.sensor]
    dt = 1.0 / spec.rate_hz
    rng = np.random.default_rng(spec.seed + 1000)
    scans, ts, gt = [], [], []
    for i in range(spec.n_scans):
        t0 = i * dt
        scans.append(render_sweep(world, traj, t0, beam=beam,
                                  scan_duration=dt,
                                  spin_clockwise=spin_clockwise, rng=rng))
        ts.append(t0)
        gt.append(traj.pose(t0))
    seq = SyntheticSequence(scans=scans, timestamps=ts, ground_truth=gt)
    if cache_path:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            offs = np.cumsum([0] + [s.shape[0] for s in scans]).astype(np.int64)
            np.savez_compressed(
                cache_path + ".tmp.npz", points=np.concatenate(scans, axis=0),
                offsets=offs, ts=np.asarray(ts, np.float64),
                gt=np.stack(gt).astype(np.float64))
            os.replace(cache_path + ".tmp.npz", cache_path)
        except Exception as e:
            print(f"[lidar_sim] cache write failed ({e})")
    return seq


# Named benchmark sequences for RESULTS.md — keep specs stable so recorded
# numbers stay reproducible from the CLI (`--sim <name>`).  Speeds are
# realistic for the platform class (walking robot ~1.5-3 m/s, car ~8 m/s):
# a circle of radius r traversed over (n_scans / rate) seconds.
BENCHMARK_SEQUENCES = {
    # 75 m loop at ~3.2 m/s, 1.05 revolutions -> closes the loop.
    "vlp16_yard_circle": SimSequenceSpec(
        name="vlp16_yard_circle", sensor="vlp16", world="yard",
        trajectory="circle", n_scans=260, seed=0,
        traj_kwargs=dict(radius=12.0), param_file="velodyne_puck16.yaml"),
    # Figure-8, both turn directions, ~3.5 m/s.  a=28 spans ~56 m so the
    # self-crossing lands in a NON-adjacent submap on the second pass (the
    # r4 a=12 course fit inside two 20 m submaps and could never close —
    # a drift showcase, not a loop-closure benchmark).
    "vlp16_yard_figure8": SimSequenceSpec(
        name="vlp16_yard_figure8", sensor="vlp16", world="yard",
        trajectory="figure8", n_scans=500, seed=2,
        world_kwargs=dict(extent=60.0, n_buildings=24, n_poles=60),
        traj_kwargs=dict(a=28.0),
        param_file="velodyne_puck16.yaml"),
    # 75 m loop driven 2.3 times at ~3.1 m/s: lap 2 re-enters every lap-1
    # region, so each finished lap-2 submap is a loop-closure candidate
    # against its non-adjacent lap-1 neighbor — the multi-closure benchmark
    # (constraint dedup, BFS min-submaps-between gating, and repeated
    # optimize/apply rounds all see real traffic;
    # AdjacencyMatrix.cpp:23-55, OptimizationProblem.cpp:177-189).
    "vlp16_yard_two_loops": SimSequenceSpec(
        name="vlp16_yard_two_loops", sensor="vlp16", world="yard",
        trajectory="circle", n_scans=560, seed=5,
        traj_kwargs=dict(radius=12.0, period=560 / 10.0 / 2.3),
        param_file="velodyne_puck16.yaml"),
    # 138 m loop at ~8 m/s (vehicle speed, KITTI-class sensor).  period is
    # explicit: vehicles legitimately exceed the walking-speed default floor.
    # 1.2 revolutions: the closing arc RE-TRAVERSES ~20% of the loop, like
    # the revisits in real loop-closure datasets — a 1.05-rev drive leaves
    # only a sliver of genuine submap overlap (measured: the single
    # candidate pair tops out at refinement fitness 0.78 against the
    # reference-mirrored 0.8 acceptance gate).
    "hdl64_yard_drive": SimSequenceSpec(
        name="hdl64_yard_drive", sensor="hdl64", world="yard",
        trajectory="circle", n_scans=200, seed=3,
        world_kwargs=dict(extent=55.0, n_buildings=14),
        traj_kwargs=dict(radius=22.0, z=1.8, period=200 / 10.0 / 1.2),
        param_file="velodyne_hdl64_kitti.yaml"),
    # Indoor walk, short-range wide-FOV sensor.
    "os0_corridor_walk": SimSequenceSpec(
        name="os0_corridor_walk", sensor="os0_128", world="corridor",
        trajectory="straight", n_scans=120, seed=4,
        traj_kwargs=dict(speed=1.2, z=1.0),
        param_file="ouster_os0_128.yaml"),
}
