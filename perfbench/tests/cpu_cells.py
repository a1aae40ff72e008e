"""The cells at a size a CPU test run can hold: the same runners, traffic
generators, reference and checks, with the sensor, the capacities, the
lap and the site cut down.  For the harness's own tests only; a benchmark
run never takes these sizes."""
import copy
import time

import numpy as np

import planted
from perfbench import core

MAPPING = "vlp16_mapping.revisit_loops"

_MAPPING_SIZES = {
    "sensor": {"elevations_deg": np.linspace(-15.0, 15.0, 16).tolist(), "azimuth_steps": 450},
    "slam_parameters": {
        "capacities": {"raw_scan": 8192, "processed_scan": 2048, "submap_points": 8192,
                       "map_patch": 4096, "feature_cloud": 1024, "max_submaps": 32,
                       "max_constraints": 128, "dense_submap_voxels": 8192},
        "mapper": {"is_print_timing_statistics": False, "submaps": {"radius": 5.0},
                   "place_recognition": {"loop_closure_search_radius": 12.0}}},
}


def _merge(into: dict, values: dict):
    for k, v in values.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = copy.deepcopy(v)


def files_at_test_size(workload: str, checks: dict = None) -> dict:
    files = copy.deepcopy(core.cell_files(core.benchmark(), workload))
    t = files["traffic"]
    t["trajectory"].update(radius=6.0, period_s=12.0)
    t["world"].update(extent=15.0, n_buildings=4, n_poles=8)
    t["render_scans_per_window_s"] = 40
    _merge(files["config"], _MAPPING_SIZES)
    for k, v in (checks or {}).items():
        files["checks"][k]["limit"] = v
    return files


def run(workload: str, seed: int, seconds: float, trace: bool = False,
        plant: str = "", checks: dict = None) -> dict:
    """One run on the CPU, with ``plant`` (``planted.PLANTS``) in place when
    given; returns the runner's output with ``correct``."""
    t0 = time.perf_counter()
    files = files_at_test_size(workload, checks)
    undo = planted.plant(plant, files) if plant else (lambda: None)
    try:
        out = core.runner(files["config"]).run(files, seed, seconds, trace, "cpu", t0)
    finally:
        undo()
    out["correct"] = all(core.passes(c["value"], c["op"], c["limit"]) for c in out["checks"])
    return out
