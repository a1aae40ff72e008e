"""Device time of the port's hand-written kernels a query (the ``__global__``
functions of ``open3d_slam_torch/csrc``, read at run time), from the
profiler's trace of a relocalization run's traced window's second half."""


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("profiled_queries"):
        return None
    return trace["profile"]["hand_written_ms"] / trace["profiled_queries"]
