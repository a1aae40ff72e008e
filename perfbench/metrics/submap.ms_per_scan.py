"""Time of the submap insert a scan (``SubmapCollection.insert_scan``: the
active-submap switch, the overlap replay, the sorted-store insert and
carving), synchronised spans of the traced window's first half."""


def read(trace):
    if trace.get("kind") != "mapping" or "submap" not in trace["spans"]:
        return None
    return trace["spans"]["submap"]["self_ms"] / trace["synced_scans"]
