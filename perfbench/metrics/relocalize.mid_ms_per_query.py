"""The ``relocalize.mid`` stage a query (the point-to-point pull-in of the
best hypotheses: K3's correspondences and the Kabsch step), bracketed by
device synchronisations (the program's ``profile`` of
``SlamMapInitializer.relocalize``), over the traced window's first half."""


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("synced_queries"):
        return None
    return trace["stage_ms"].get("mid", 0.0) / trace["synced_queries"]
