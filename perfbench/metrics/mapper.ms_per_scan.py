"""Self time of the mapper layer a scan (``Mapper.preprocess_scan``,
``dispatch_range_measurement``, ``finalize_range_measurement``, less the
submap insert and the GN loops), synchronised spans of the traced window's
first half."""


def read(trace):
    if trace.get("kind") != "mapping" or "mapper" not in trace["spans"]:
        return None
    return trace["spans"]["mapper"]["self_ms"] / trace["synced_scans"]
