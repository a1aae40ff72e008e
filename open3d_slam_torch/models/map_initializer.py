"""SlamMapInitializer: the localization-mode bootstrap.

Port of ``open3d_slam_tpu.models.map_initializer`` (reference
``SlamMapInitializer.cpp:51-93``):

  * ``initialize``: set the initial map and, if given, the initial
    transform (``:56-64``);
  * ``relocalize``: where the reference waits for the operator's initial
    pose, find it from one raw scan by multi-start global localization in
    the loaded map (``parallel/multi_start.py``), the entry point of
    ``cli/localization.py --global-init``; the funnel's map-side products
    are built at the first query against a map and kept for the next;
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

from typing import Optional, Tuple

import numpy as np

from open3d_slam_torch.parallel import multi_start
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.timeutil import telemetry


class SlamMapInitializer:
    def __init__(self, slam):
        self.slam = slam
        self._saved_is_merge: Optional[bool] = None
        self._pending_gate_restore = False
        # The funnel's products of the last map relocalized in:
        # (map cloud, key, multi_start.MapProducts).
        self._prepared: Optional[tuple] = None

    def initialize(self, map_points: np.ndarray,
                   initial_pose: Optional[np.ndarray] = None):
        """``SlamMapInitializer::initialize`` (``:56-64``)."""
        self.slam.set_initial_map(map_points)
        if initial_pose is not None:
            self.slam.set_initial_transform(np.asarray(initial_pose))

    @telemetry.spanned("relocalize.query")
    def relocalize(self, points: np.ndarray, num_hypotheses: Optional[int] = None,
                   keep: Optional[dict] = None,
                   profile: Optional[dict] = None) -> Tuple[np.ndarray, float]:
        """Localize one raw scan (sensor frame, (n, 3); non-finite rows are
        dropped) in the loaded map with no initial pose, and set the result
        as the initial transform.  The query is built at
        ``capacities.raw_scan``; ``multi_start.global_localize`` runs against
        the active submap's map with ``capacities.localization_hypotheses``
        hypotheses unless ``num_hypotheses`` is given.  The map's products
        (``multi_start.prepare_map``) are kept from the last query while the
        map and what they are built from stay the same; the answer is that
        of ``global_localize`` bit for bit.  ``keep`` and ``profile`` as
        ``global_localize``'s.  Returns (T (4, 4) float64, fitness)."""
        slam = self.slam
        submap = slam.mapper.submaps.get_active_submap()
        if submap.is_empty():
            raise RuntimeError("relocalize needs a loaded map: call initialize first")
        cap = slam.params.capacities
        pts = np.asarray(points, np.float32)
        scan = pclib.from_numpy(pts[np.isfinite(pts).all(axis=1)], capacity=cap.raw_scan,
                                device=slam.device)
        n = num_hypotheses or cap.localization_hypotheses
        T, fitness = multi_start.localize(
            scan, lambda: self._map_products(submap.map_cloud, n), slam.params,
            keep=keep, profile=profile)
        slam.set_initial_transform(T)
        return T, fitness

    def _map_products(self, map_cloud, num_hypotheses: int) -> multi_start.MapProducts:
        """The funnel's products of ``map_cloud``, kept from the last call
        when it is the same cloud object with the same hypothesis count, device
        and settings.  A submap never writes its cloud's tensors in place: a
        load, a merge or a transform assigns a new cloud, so the held
        reference also keeps its id from being reused."""
        key = (num_hypotheses, map_cloud.device, multi_start.map_settings(self.slam.params))
        held = self._prepared
        if held is not None and held[0] is map_cloud and held[1] == key:
            telemetry.count("relocalize.map_prep_hits")
            return held[2]
        telemetry.count("relocalize.map_prep_builds")
        self._prepared = None      # the old products go before the new are built
        products = multi_start.prepare_map(map_cloud, self.slam.params, num_hypotheses)
        self._prepared = (map_cloud, key, products)
        return products

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
