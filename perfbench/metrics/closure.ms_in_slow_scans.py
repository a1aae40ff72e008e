"""The mean, over the profiled half's scans whose ``slam_wrapper.scan`` span
is at or above its 95th percentile, of the time inside that scan's
outermost ``closure.*`` and ``optimization.*`` spans."""
from perfbench import program_spans


def read(trace):
    program = program_spans.program_of(trace)
    if program is None:
        return None
    return program["closure_ms_in_slow_scans"]
