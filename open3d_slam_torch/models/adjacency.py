"""Undirected submap adjacency graph and loop-closure flags.

Port of ``open3d_slam_tpu.models.adjacency``, mirror of the reference's
``AdjacencyMatrix`` (``src/AdjacencyMatrix.cpp``): addEdge, isAdjacent,
markAsLoopClosureSubmap and the BFS distance to the nearest loop-closure
submap.  Pure host-side control flow.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Set


class AdjacencyMatrix:
    def __init__(self):
        self.adj: Dict[int, Set[int]] = {}
        self.loop_closure_submaps: Set[int] = set()

    def add_edge(self, a: int, b: int):
        self.adj.setdefault(a, set()).add(b)
        self.adj.setdefault(b, set()).add(a)

    def is_adjacent(self, a: int, b: int) -> bool:
        if a == b:
            return True
        return b in self.adj.get(a, set())

    def mark_as_loop_closure_submap(self, idx: int):
        self.loop_closure_submaps.add(idx)

    def is_loop_closure_submap(self, idx: int) -> bool:
        return idx in self.loop_closure_submaps

    def get_distance_to_nearest_loop_closure_submap(self, start: int) -> int:
        """BFS hop distance (``AdjacencyMatrix.cpp:23-55``); large if none."""
        if self.is_loop_closure_submap(start):
            return 0
        seen = {start}
        q = deque([(start, 0)])
        while q:
            node, d = q.popleft()
            for nb in self.adj.get(node, set()):
                if nb in seen:
                    continue
                if self.is_loop_closure_submap(nb):
                    return d + 1
                seen.add(nb)
                q.append((nb, d + 1))
        return 1 << 30
