"""Undirected submap adjacency graph.

Port of the main-path part of ``open3d_slam_tpu.models.adjacency``, mirror of
the reference's ``AdjacencyMatrix`` (``src/AdjacencyMatrix.cpp``): addEdge
and isAdjacent.  The loop-closure flags and the distance to the nearest
loop-closure submap arrive with the loop-closure slice.  Pure host-side
control flow.
"""
from __future__ import annotations

from typing import Dict, Set


class AdjacencyMatrix:
    def __init__(self):
        self.adj: Dict[int, Set[int]] = {}

    def add_edge(self, a: int, b: int):
        self.adj.setdefault(a, set()).add(b)
        self.adj.setdefault(b, set()).add(a)

    def is_adjacent(self, a: int, b: int) -> bool:
        if a == b:
            return True
        return b in self.adj.get(a, set())
