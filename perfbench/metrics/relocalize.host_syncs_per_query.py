"""Blocking device-to-host pulls a query (``utils.device.host_syncs``, which
counts every pull through ``to_host``), over the profiled half of a
relocalization run's traced window."""


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("profiled_queries"):
        return None
    return trace["host_syncs"] / trace["profiled_queries"]
