"""What ``correct`` has to catch in the relocalization cell, planted into a
run: the control in the reference's place, and faults in the timed path
(PERF.md, "How correct is decided").  A benchmark run never plants
anything; the harness's CPU tests and the measurements of each check's
readings do.

    python3 perfbench/tests/planted_relocalize.py --plant <name> \\
        --workload vlp16_relocalize.kidnapped --seed <n> --seconds <s> [--trace 0|1]

runs the cell as ``perfbench/run.py`` does, with the planting in place,
from the root of a checkout on a card.  The plantings:

- ``control``: the reference computed in bfloat16, the precision below the
  configuration's float32 that holds the map's range;
- ``unrefined``: the funnel returns the rank stage's winner as it is;
- ``mid_skipped``: the mid stage's Kabsch loop returns its start (no
  iteration);
- ``final_skipped``: the funnel returns the refined winner and its fitness,
  without the final stage;
- ``refine_fitness``: the final pose with the refine stage's fitness;
- ``map_bf16``: the map rounded to bfloat16 where it is loaded;
- ``scan_bf16``: each query scan rounded to bfloat16 where it comes in.
"""
import os
import sys
from typing import Callable

import numpy as np
import torch


def _patch(owner, attr, make) -> Callable[[], None]:
    fn = getattr(owner, attr)
    setattr(owner, attr, make(fn))
    return lambda: setattr(owner, attr, fn)


def _control(files: dict) -> Callable[[], None]:
    from perfbench.reference import relocalize as ref
    saved = ref.DTYPE
    ref.DTYPE = torch.bfloat16
    return lambda: setattr(ref, "DTYPE", saved)


def _answer(pick) -> Callable[[dict], Callable[[], None]]:
    """A planting that replaces the funnel's answer by ``pick(keep)``, from
    the stage outputs it keeps."""
    def planting(files: dict) -> Callable[[], None]:
        from open3d_slam_torch.parallel import multi_start

        def make(fn):
            def batched_localize(*args, **kwargs):
                keep = kwargs["keep"] if kwargs.get("keep") is not None else {}
                kwargs["keep"] = keep
                fn(*args, **kwargs)
                return pick(keep)
            return batched_localize
        return _patch(multi_start, "batched_localize", make)
    return planting


def _rank_winner(keep):
    best = torch.argmax(keep["rank_score"])
    return keep["coarse_T"][best], keep["refined_fitness"]


def _bf16(a) -> np.ndarray:
    return torch.as_tensor(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _map_bf16(files: dict) -> Callable[[], None]:
    from open3d_slam_torch.models.slam_wrapper import SlamWrapper

    def make(fn):
        return lambda self, map_points, *a, **k: fn(self, _bf16(map_points), *a, **k)
    return _patch(SlamWrapper, "set_initial_map", make)


def _scan_bf16(files: dict) -> Callable[[], None]:
    from open3d_slam_torch.models.map_initializer import SlamMapInitializer

    def make(fn):
        return lambda self, points, *a, **k: fn(self, _bf16(points), *a, **k)
    return _patch(SlamMapInitializer, "relocalize", make)


def _mid_skipped(files: dict) -> Callable[[], None]:
    from open3d_slam_torch.ops import registration

    def make(fn):
        def batched_icp_point_to_point(*args, **kwargs):
            kwargs["max_iterations"] = 0
            return fn(*args, **kwargs)
        return batched_icp_point_to_point
    return _patch(registration, "batched_icp_point_to_point", make)


PLANTS = {
    "control": _control,
    "unrefined": _answer(_rank_winner),
    "mid_skipped": _mid_skipped,
    "final_skipped": _answer(lambda k: (k["refined_T"], k["refined_fitness"])),
    "refine_fitness": _answer(lambda k: (k["final_T"], k["refined_fitness"])),
    "map_bf16": _map_bf16,
    "scan_bf16": _scan_bf16,
}


def plant(name: str, files: dict) -> Callable[[], None]:
    """Puts planting ``name`` in place for a run of ``files``; returns what
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
