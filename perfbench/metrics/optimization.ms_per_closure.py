"""Time of an accepted closure's pose-graph round (``SlamWrapper._finish_loop_closure``
with constraints: the constraints pulled, the graph built and solved), a
round, synchronised spans of the traced window's first half; nothing when
the half accepted no closure."""


def read(trace):
    span = trace.get("spans", {}).get("optimization")
    if trace.get("kind") != "mapping" or not span or not span["calls"]:
        return None
    return span["ms"] / span["calls"]
