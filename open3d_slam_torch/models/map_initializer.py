"""SlamMapInitializer: the localization-mode bootstrap.

Port of ``open3d_slam_tpu.models.map_initializer`` (reference
``SlamMapInitializer.cpp:51-93``), host-only:

  * ``initialize``: set the initial map and, if given, the initial
    transform (``:56-64``);
  * the interactive window (``initializeWorker``, ``:79-93``): while the
    operator aligns the pose, merging is off and the min-refinement-fitness
    gate is ignored, so scan-to-map refinement keeps publishing a pose even
    from a bad alignment; on confirmation merging is restored at once and
    the gate one processed scan later (the reference sleeps 1 s for the same
    "let one refinement land first", ``:89-91``).

The rviz marker and ``/initialpose`` become ``update_pose`` calls;
``cli/localization.py``'s ``--initial-pose`` / ``--global-init`` serve
non-interactive use.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class SlamMapInitializer:
    def __init__(self, slam):
        self.slam = slam
        self._saved_is_merge: Optional[bool] = None
        self._pending_gate_restore = False

    def initialize(self, map_points: np.ndarray,
                   initial_pose: Optional[np.ndarray] = None):
        """``SlamMapInitializer::initialize`` (``:56-64``)."""
        self.slam.set_initial_map(map_points)
        if initial_pose is not None:
            self.slam.set_initial_transform(np.asarray(initial_pose))

    def begin_interactive_init(self):
        """Relax the gates while the operator aligns the pose."""
        p = self.slam.params.mapper
        self._saved_is_merge = p.is_merge_scans_into_map
        p.is_merge_scans_into_map = False
        p.is_ignore_min_refinement_fitness = True

    def update_pose(self, T: np.ndarray):
        """Marker drag / ``/initialpose`` (``:38-44``)."""
        self.slam.set_initial_transform(np.asarray(T))

    def finish_initialization(self):
        """The ``initialize_slam`` trigger (``:46-50``) and the worker's
        epilogue: merging back now, the fitness gate after the next scan
        (``notify_scan_processed``)."""
        p = self.slam.params.mapper
        if self._saved_is_merge is not None:
            p.is_merge_scans_into_map = self._saved_is_merge
            self._saved_is_merge = None
        self._pending_gate_restore = True

    def notify_scan_processed(self):
        """Call after each processed scan; completes the deferred gate
        restore (``:89-91``)."""
        if self._pending_gate_restore:
            self.slam.params.mapper.is_ignore_min_refinement_fitness = False
            self._pending_gate_restore = False
            print("Finished setting initial map!")
