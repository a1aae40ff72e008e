"""Device time of the port's hand-written kernels a scan (the ``__global__``
functions of ``open3d_slam_torch/csrc``, read at run time), from the
profiler's trace of the traced window's second half."""


def read(trace):
    if trace.get("kind") != "mapping" or not trace["profiled_scans"]:
        return None
    return trace["profile"]["hand_written_ms"] / trace["profiled_scans"]
