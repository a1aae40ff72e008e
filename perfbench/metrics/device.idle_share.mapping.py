"""1 - (union of the device's intervals / wall time) over the profiled
second half of a mapping run's traced window."""


def read(trace):
    if trace.get("kind") != "mapping" or trace["profile"]["window_s"] <= 0:
        return None
    return 1.0 - trace["profile"]["busy_s"] / trace["profile"]["window_s"]
