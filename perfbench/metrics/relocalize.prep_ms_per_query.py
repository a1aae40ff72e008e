"""The ``relocalize.prep`` stage a query (the query's voxelized and random
subsamples, the map's hash grids, its host pull, the coarse map with its
normals, the mid map, the pose hypotheses): each stage bracketed by device
synchronisations (the program's ``profile`` of ``SlamMapInitializer.relocalize``),
over the traced window's first half."""


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("synced_queries"):
        return None
    return trace["stage_ms"].get("prep", 0.0) / trace["synced_queries"]
