"""Closure jobs that gave constraints over closure jobs started
(``closure.jobs_with_constraints`` / ``closure.jobs_started``, the
program's counters) over the traced window's profiled half; nothing when
no job started."""
from perfbench import program_spans


def read(trace):
    program = program_spans.program_of(trace)
    if program is None:
        return None
    started = program["counters"].get("closure.jobs_started", 0)
    if not started:
        return None
    return program["counters"].get("closure.jobs_with_constraints", 0) / started
