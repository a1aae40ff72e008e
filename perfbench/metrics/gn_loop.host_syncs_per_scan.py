"""Blocking pulls a scan made inside a ``gn_loop.*`` span (the Gauss-Newton
loops' ``done`` reads), from the program's ``pulls`` counter by span, over
the traced window's profiled half."""
from perfbench import program_spans


def read(trace):
    program = program_spans.program_of(trace)
    if program is None:
        return None
    return program_spans.per_scan(program, trace["profiled_scans"], float(sum(
        n for span, n in program["pulls_by_span"].items() if span.startswith("gn_loop."))))
