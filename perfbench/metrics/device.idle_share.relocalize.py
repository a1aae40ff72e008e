"""1 - (union of the device's intervals / wall time) over the profiled
second half of a relocalization run's traced window."""


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("profile", {}).get("window_s"):
        return None
    return 1.0 - trace["profile"]["busy_s"] / trace["profile"]["window_s"]
