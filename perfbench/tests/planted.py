"""What ``correct`` has to catch, planted into a run: the control in the
program's place, and faults in the timed path (PERF.md, "How correct is
decided").  A benchmark run never plants anything; the harness's CPU tests
and the measurements of each check's upper reading do.

    python3 perfbench/tests/planted.py --plant <name> --workload <cell> \\
        --seed <n> --seconds <s> [--trace 0|1]

runs one cell as ``perfbench/run.py`` does, with the planting in place,
from the root of a checkout on a card.  The plantings:

- ``control``: the configuration's guarantee "undistortion on" broken (the
  configuration states no precision to go below);
- ``registrations_unchanged``: both registrations do their work and return
  the pose they started from (a step that returns its state unchanged);
- ``poses_altered``: every pose the mapper produces has its translation
  read 2% long where it is produced (an answer altered);
- ``solve_unchanged``: the pose-graph solve does its work and returns the
  poses it started from (a step that returns its state unchanged).
"""
import dataclasses
import os
import sys
from typing import Callable

import numpy as np


def _control(files: dict) -> Callable[[], None]:
    params = files["config"]["slam_parameters"]
    params.setdefault("motion_compensation", {})["is_undistort_input_cloud"] = False
    return lambda: None


def _patch(owner, attr, make) -> Callable[[], None]:
    fn = getattr(owner, attr)
    setattr(owner, attr, make(fn))
    return lambda: setattr(owner, attr, fn)


def _registrations_unchanged(files: dict) -> Callable[[], None]:
    from open3d_slam_torch.models.cloud_registration import CloudRegistrationStrategy

    def make(fn):
        def register(self, source, target, init, source_order=None):
            res = fn(self, source, target, init, source_order=source_order)
            return dataclasses.replace(res, transformation=init)
        return register
    return _patch(CloudRegistrationStrategy, "register", make)


def _poses_altered(files: dict) -> Callable[[], None]:
    from open3d_slam_torch.models.mapper import Mapper

    def make(fn):
        def init(self, *args, **kwargs):
            fn(self, *args, **kwargs)
            buf = self.map_to_range_sensor_buffer
            push = buf.push

            def altered(time, transform):
                T = np.array(transform, np.float64).reshape(4, 4)
                T[:3, 3] *= 1.02
                return push(time, T)
            buf.push = altered
        return init
    return _patch(Mapper, "__init__", make)


def _solve_unchanged(files: dict) -> Callable[[], None]:
    from open3d_slam_torch.models.optimization import OptimizationProblem

    def make(fn):
        def solve(self):
            done = self.node_poses_optimized or []
            start = [np.array(done[i] if i < len(done) else self.node_poses[i])
                     for i in range(len(self.node_poses))]
            out = fn(self)
            self.node_poses_optimized = start
            return out
        return solve
    return _patch(OptimizationProblem, "solve", make)


PLANTS = {"control": _control, "registrations_unchanged": _registrations_unchanged,
          "poses_altered": _poses_altered, "solve_unchanged": _solve_unchanged}


def plant(name: str, files: dict) -> Callable[[], None]:
    """Puts planting ``name`` in place for a run of ``files`` (the cell's
    files as ``core.cell_files`` gives them, edited in place); returns what
    takes it out again."""
    return PLANTS[name](files)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--plant")
    name = argv[i + 1]
    del argv[i:i + 2]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from perfbench import core, run
    cell_files = core.cell_files

    def planted(bench, workload):
        files = cell_files(bench, workload)
        plant(name, files)
        return files

    core.cell_files = planted
    print(f"perfbench: planted {name}", file=sys.stderr)
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
