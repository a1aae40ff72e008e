"""The relocalization cell at a size a CPU test run can hold: the same
runner, generator, reference and checks, with the sensor, the capacities,
the hypotheses, the map's voxels and the site cut down.  The capacities
stay below the query's returns and the map's points, as the cell's do, so
the test size runs the paths that hold a raw scan and a whole map.  For the
harness's own tests only; a benchmark run never takes these sizes."""
import copy
import time

import numpy as np

import planted_relocalize
from perfbench import core

RELOCALIZE = "vlp16_relocalize.kidnapped"

_SIZES = {
    "sensor": {"elevations_deg": np.linspace(-15.0, 15.0, 16).tolist(), "azimuth_steps": 256},
    "slam_parameters": {
        "capacities": {"raw_scan": 4096, "processed_scan": 2048, "submap_points": 1024,
                       "map_patch": 2048, "feature_cloud": 256, "localization_hypotheses": 16},
        "mapper": {"is_print_timing_statistics": False, "map_builder": {"map_voxel_size": 1.0}}},
}


def _merge(into: dict, values: dict):
    for k, v in values.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = copy.deepcopy(v)


def files_at_test_size(checks: dict = None) -> dict:
    files = copy.deepcopy(core.cell_files(core.benchmark(), RELOCALIZE))
    t = files["traffic"]
    t["trajectory"].update(radius=6.0, period_s=12.0)
    t["world"].update(extent=15.0, n_buildings=4, n_poles=8, keep_clear_duration_s=12.0)
    t["queries"].update(radial_offset_m=1.0, warmup=1, render_per_window_s=1)
    _merge(files["config"], _SIZES)
    for k, v in (checks or {}).items():
        files["checks"][k]["limit"] = v
    return files


def run(seed: int, seconds: float, plant: str = "", checks: dict = None) -> dict:
    """One run on the CPU, with ``plant`` (``planted_relocalize.PLANTS``) in
    place when given; returns the runner's output with ``correct``."""
    t0 = time.perf_counter()
    files = files_at_test_size(checks)
    undo = planted_relocalize.plant(plant, files) if plant else (lambda: None)
    try:
        out = core.runner(files["config"]).run(files, seed, seconds, False, "cpu", t0)
    finally:
        undo()
    out["correct"] = all(core.passes(c["value"], c["op"], c["limit"]) for c in out["checks"])
    return out
