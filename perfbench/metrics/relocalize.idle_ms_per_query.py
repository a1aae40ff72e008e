"""Device idle a query under the program's ``relocalize.*`` spans (the query,
its stages, and the GN loops and pulls inside them): each idle gap of the
device in the traced window's profiled half is credited to the innermost
program span of the main thread at its middle, and from there to its
``relocalize.*`` ancestor (``perfbench/runners/relocalize.py``)."""


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("profiled_queries"):
        return None
    return sum(trace["idle_ms_by_stage"].values()) / trace["profiled_queries"]
