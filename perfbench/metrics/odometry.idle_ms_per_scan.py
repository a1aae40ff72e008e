"""Device idle a scan under the program's ``odometry.*`` spans (the scan's
dispatch, preprocess, downsample, normals, target preparation, register) and
the pulls made in them, innermost: each idle gap of the device in the traced
window's profiled half is credited to the innermost program span of the main
thread at its middle (``perfbench/program_spans.py``)."""
from perfbench import program_spans


def read(trace):
    program = program_spans.program_of(trace)
    if program is None:
        return None
    return program_spans.per_scan(program, trace["profiled_scans"],
                                  program["idle_s_by_layer"].get("odometry", 0.0) * 1e3)
