"""Self time of the odometry layer a scan (``LidarOdometry.add_range_scan_async``:
preprocess, target preparation, scan-to-scan registration, less the GN
loops), synchronised spans of the traced window's first half."""


def read(trace):
    if trace.get("kind") != "mapping" or "odometry" not in trace["spans"]:
        return None
    return trace["spans"]["odometry"]["self_ms"] / trace["synced_scans"]
