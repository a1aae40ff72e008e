"""Time a scan inside the program's ``pull`` spans (each blocking
device->host pull of ``utils.device.to_host``), over the traced window's
profiled half."""
from perfbench import program_spans


def read(trace):
    program = program_spans.program_of(trace)
    if program is None:
        return None
    return program_spans.per_scan(program, trace["profiled_scans"],
                                  sum(program["pull_wait_ms_by_span"].values()))
