"""Spinning-beam LiDAR sequences, rendered on the card in float64.

The benchmark's own copy of the simulator the port's sequences come from
(``open3d_slam_torch/io/lidar_sim.py``: the yard world, the circle
trajectory, the rolling-shutter sweep with range noise and dropout), so a
change to the program cannot change the yardstick.  The world's primitives
are drawn with numpy exactly as there; the ray casting (a minimum over
primitives of elementwise ray tests) is plain torch on whatever device it is
given, batched over scans.

Every scan has its own random stream, seeded from (run seed, log, scan
index): the same seed gives the same scans, and a scan does not depend on
how many were rendered before it.  The program receives host numpy arrays, as a
sensor's stream gives them.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

F64 = torch.float64
GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0      # spreads the logs' starts over the lap


def stream_seed(*parts) -> int:
    """A 63-bit seed from the run seed and the indices that name a stream."""
    h = hashlib.sha256(":".join(str(int(p)) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


class Beam:
    """A sensor's channel table: ring elevations (degrees), azimuth columns
    per revolution, range limits, 1-sigma range noise and dropout."""

    def __init__(self, spec: dict):
        self.elevations_deg = tuple(float(e) for e in spec["elevations_deg"])
        self.azimuth_steps = int(spec["azimuth_steps"])
        self.max_range = float(spec["max_range"])
        self.min_range = float(spec["min_range"])
        self.range_noise_std = float(spec["range_noise_std"])
        self.dropout = float(spec["dropout"])
        self.spin_clockwise = bool(spec.get("spin_clockwise", True))


class CircleTrajectory:
    """A circle of ``radius`` driven at constant speed, one lap per
    ``period`` seconds, at height ``z``, heading along the path."""

    def __init__(self, radius: float, period: float, z: float):
        self.radius, self.period, self.z = float(radius), float(period), float(z)

    def poses(self, t: torch.Tensor) -> torch.Tensor:
        """(T,) times -> (T, 4, 4) poses, float64."""
        a = 2 * math.pi * t / self.period
        yaw = a + math.pi / 2
        out = torch.zeros(t.shape + (4, 4), dtype=F64, device=t.device)
        c, s = torch.cos(yaw), torch.sin(yaw)
        out[..., 0, 0], out[..., 0, 1] = c, -s
        out[..., 1, 0], out[..., 1, 1] = s, c
        out[..., 2, 2] = 1.0
        out[..., 3, 3] = 1.0
        out[..., 0, 3] = self.radius * torch.cos(a)
        out[..., 1, 3] = self.radius * torch.sin(a)
        out[..., 2, 3] = self.z
        return out


class YardWorld:
    """Ground plane, four boundary walls, buildings (boxes) and poles
    (vertical cylinders), placed as ``lidar_sim.make_yard_world`` places
    them: the same numpy draws for the same ``seed``, footprints kept
    ``clear_radius`` off the ``keep_clear`` points."""

    def __init__(self, extent: float, n_buildings: int, n_poles: int, seed: int,
                 keep_clear: Optional[np.ndarray], clear_radius: float = 3.0):
        rng = np.random.default_rng(seed)
        e = float(extent)
        self.extent, self.z0 = e, 0.0
        wall_h, wall_t = 4.0, 0.3
        boxes = [([-e, e - wall_t, 0], [e, e, wall_h]),
                 ([-e, -e, 0], [e, -e + wall_t, wall_h]),
                 ([e - wall_t, -e, 0], [e, e, wall_h]),
                 ([-e, -e, 0], [-e + wall_t, e, wall_h])]
        cyls = []

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
                boxes.append(([cx - wx, cy - wy, 0], [cx + wx, cy + wy, h]))
                made += 1
        made = 0
        for _ in range(400):
            if made >= n_poles:
                break
            cx, cy = rng.uniform(-0.9 * e, 0.9 * e, 2)
            r = rng.uniform(0.08, 0.35)
            h = rng.uniform(2.0, 6.0)
            if clear(cx, cy, r):
                cyls.append((cx, cy, r, 0.0, h))
                made += 1
        self.box_lo = np.array([b[0] for b in boxes], np.float64)
        self.box_hi = np.array([b[1] for b in boxes], np.float64)
        self.cylinders = np.array(cyls, np.float64).reshape(-1, 5)

    def raycast(self, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """First-hit distance of each ray (origins and unit directions (R, 3),
        float64), +inf where nothing is hit."""
        dev = o.device
        inf = torch.tensor(float("inf"), dtype=F64, device=dev)
        # Ground plane z = z0 over |x|, |y| <= extent.
        t = (self.z0 - o[:, 2]) / d[:, 2]
        p = o + t[:, None] * d
        ok = (t > 0) & torch.isfinite(t) & (p[:, 0].abs() <= self.extent) & \
            (p[:, 1].abs() <= self.extent)
        best = torch.where(ok, t, inf)
        # Boxes, all at once: the entry face, or the exit face from inside.
        lo = torch.as_tensor(self.box_lo, device=dev)[None]
        hi = torch.as_tensor(self.box_hi, device=dev)[None]
        inv = 1.0 / d[:, None, :]
        t1 = (lo - o[:, None, :]) * inv
        t2 = (hi - o[:, None, :]) * inv
        tmin = torch.minimum(t1, t2).amax(dim=2)
        tmax = torch.maximum(t1, t2).amin(dim=2)
        ok = (tmax >= tmin) & (tmax > 0)
        tb = torch.where(ok, torch.where(tmin > 0, tmin, tmax), inf)
        best = torch.minimum(best, tb.amin(dim=1))
        if len(self.cylinders):
            cy = torch.as_tensor(self.cylinders, device=dev)
            ocx = o[:, None, 0] - cy[None, :, 0]
            ocy = o[:, None, 1] - cy[None, :, 1]
            a = (d[:, 0:1] ** 2 + d[:, 1:2] ** 2)
            b = 2.0 * (ocx * d[:, 0:1] + ocy * d[:, 1:2])
            c = ocx ** 2 + ocy ** 2 - cy[None, :, 2] ** 2
            disc = b * b - 4 * a * c
            tc = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
            z = o[:, None, 2] + tc * d[:, 2:3]
            ok = (disc > 0) & (a > 1e-12) & (tc > 0) & (z >= cy[None, :, 3]) & \
                (z <= cy[None, :, 4])
            best = torch.minimum(best, torch.where(ok, tc, inf).amin(dim=1))
        return best


class SweepRenderer:
    """Renders full revolutions of ``beam`` along ``traj`` in ``world``:
    each azimuth column is cast from the sensor pose at its own time and
    stored in that instantaneous sensor frame (the skew a raw sensor
    stream has), the scan stamped at its sweep start."""

    def __init__(self, world: YardWorld, traj: CircleTrajectory, beam: Beam,
                 scan_duration: float, device):
        self.world, self.traj, self.beam = world, traj, beam
        self.scan_duration = float(scan_duration)
        self.device = torch.device(device)
        k, nb = beam.azimuth_steps, len(beam.elevations_deg)
        self.phase = (torch.arange(k, dtype=F64, device=self.device) + 0.5) / k
        azim = (2 * math.pi * (1.0 - self.phase) if beam.spin_clockwise
                else 2 * math.pi * self.phase)
        elev = torch.deg2rad(torch.tensor(beam.elevations_deg, dtype=F64,
                                          device=self.device))
        ce, se = torch.cos(elev), torch.sin(elev)
        ca, sa = torch.cos(azim), torch.sin(azim)
        self.dirs = torch.stack([ca[:, None] * ce[None, :], sa[:, None] * ce[None, :],
                                 se[None, :].expand(k, nb)], dim=-1)    # (K, B, 3)

    def render(self, seed: int, starts: Sequence[float], streams: Sequence[tuple],
               batch: int = 16) -> List[np.ndarray]:
        """Scans whose sweeps start at trajectory times ``starts``; scan i
        draws its noise from the stream ``streams[i]`` of ``seed``.  Returns
        (n_i, 3) float32 host arrays."""
        beam, dev = self.beam, self.device
        k, nb = beam.azimuth_steps, len(beam.elevations_deg)
        dirs_flat = self.dirs.reshape(1, k * nb, 3)
        out: List[np.ndarray] = []
        for b0 in range(0, len(starts), batch):
            t0 = torch.tensor(list(starts[b0:b0 + batch]), dtype=F64, device=dev)
            s = t0.shape[0]
            times = t0[:, None] + self.phase[None] * self.scan_duration     # (S, K)
            T = self.traj.poses(times.reshape(-1)).reshape(s, k, 4, 4)
            o_w = T[:, :, None, :3, 3].expand(s, k, nb, 3).reshape(-1, 3)
            d_w = torch.einsum("skij,kbj->skbi", T[:, :, :3, :3], self.dirs).reshape(-1, 3)
            t_hit = self.world.raycast(o_w, d_w).reshape(s, k * nb)
            noise = torch.empty_like(t_hit)
            keep = torch.empty_like(t_hit)
            for j in range(s):
                g = torch.Generator(device=dev)
                g.manual_seed(stream_seed(seed, *streams[b0 + j]))
                noise[j] = torch.randn(k * nb, generator=g, dtype=F64, device=dev)
                keep[j] = torch.rand(k * nb, generator=g, dtype=F64, device=dev)
            r = t_hit + beam.range_noise_std * noise
            valid = torch.isfinite(t_hit) & (r > beam.min_range) & (r < beam.max_range) \
                & (keep > beam.dropout)
            pts = (r[..., None] * dirs_flat).to(torch.float32)
            counts = valid.sum(dim=1).cpu().numpy()
            flat = pts[valid].cpu().numpy()
            offs = np.concatenate([[0], np.cumsum(counts)])
            out.extend(np.ascontiguousarray(flat[offs[j]:offs[j + 1]]) for j in range(s))
        return out


class LidarSequence:
    """One log as a mapping cell gets it: scans (host float32), timestamps
    and ground-truth poses at each sweep start (float64)."""

    def __init__(self, scans, timestamps, ground_truth):
        self.scans: List[np.ndarray] = scans
        self.timestamps: List[float] = timestamps
        self.ground_truth: np.ndarray = ground_truth

    def __len__(self):
        return len(self.scans)


def circle_logs(traffic: dict, sensor: dict, seed: int, n_logs: int, log_scans: int,
                device) -> List[LidarSequence]:
    """The ``circle_logs`` generator: ``n_logs`` logs of ``log_scans`` scans
    each along a circle in a yard.  The yard (its own ``world.seed``), the
    route and each log's start on the lap are the same for every seed; the
    seed draws each scan's range noise and dropouts."""
    w, c = traffic["world"], traffic["trajectory"]
    rate = float(traffic["rate_hz"])
    traj = CircleTrajectory(c["radius"], c["period_s"], c["z"])
    # The yard keeps its footprints off the whole circle, as the named
    # sequence it copies does (its trajectory over its own duration).
    clear_t = torch.linspace(0.0, float(w["keep_clear_duration_s"]), 256, dtype=F64)
    clear = traj.poses(clear_t)[:, :2, 3].numpy()
    world = YardWorld(w["extent"], w["n_buildings"], w["n_poles"], w["seed"], clear,
                      w.get("clear_radius", 3.0))
    renderer = SweepRenderer(world, traj, Beam(sensor), 1.0 / rate, device)
    logs = []
    for k in range(n_logs):
        # Each log starts elsewhere on the lap, at the same place for every
        # seed: the route fixes the work, the seed only the sensor's noise.
        t_start = math.fmod(k * GOLDEN, 1.0) * traj.period
        starts = [t_start + i / rate for i in range(log_scans)]
        scans = renderer.render(seed, starts, [(k, i) for i in range(log_scans)])
        gt = traj.poses(torch.tensor(starts, dtype=F64)).numpy()
        logs.append(LidarSequence(scans, [i / rate for i in range(log_scans)], gt))
    return logs
