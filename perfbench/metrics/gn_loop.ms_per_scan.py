"""Time of the fused Gauss-Newton loops a scan (``registration._icp_gicp_fused_batch``
and ``_icp_p2l_fused_batch``, their CUDA-graph replays), wherever they run,
synchronised spans of the traced window's first half."""


def read(trace):
    if trace.get("kind") != "mapping" or "gn_loop" not in trace["spans"]:
        return None
    return trace["spans"]["gn_loop"]["ms"] / trace["synced_scans"]
