"""The funnel's K4 stages a query: ``relocalize.coarse``, ``.rank``,
``.refine`` and ``.final`` (the point-to-plane sweeps of the hypotheses, the
rank scores, the refinement of the best and the winner's registration), each
bracketed by device synchronisations (the program's ``profile`` of
``SlamMapInitializer.relocalize``), over the traced window's first half."""

STAGES = ("coarse", "rank", "refine", "final")


def read(trace):
    if trace.get("kind") != "relocalize" or not trace.get("synced_queries"):
        return None
    return sum(trace["stage_ms"].get(k, 0.0) for k in STAGES) / trace["synced_queries"]
