"""Blocking device-to-host pulls a scan (``utils.device.host_syncs``, which
counts every pull through ``to_host``), over the profiled half of a mapping
run's traced window."""


def read(trace):
    if trace.get("kind") != "mapping" or not trace["profiled_scans"]:
        return None
    return trace["host_syncs"] / trace["profiled_scans"]
