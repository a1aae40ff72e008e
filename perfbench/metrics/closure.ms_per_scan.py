"""Self time of the loop-closure layer a scan (``SlamWrapper.compute_features_if_ready``
and ``_advance_loop_closures``: features, odometry constraints, the closure
job's phases, less the GN loops and an accepted closure's pose-graph round),
synchronised spans of the traced window's first half."""


def read(trace):
    if trace.get("kind") != "mapping" or "closure" not in trace["spans"]:
        return None
    return trace["spans"]["closure"]["self_ms"] / trace["synced_scans"]
