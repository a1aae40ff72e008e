"""Online driver: ingest on the caller's thread, processing on a worker.

Port of ``open3d_slam_tpu.models.async_driver``.  The reference's online
mode runs ingest (the ROS spinner) and processing (worker threads) at once
(``OnlineRangeDataProcessorRos.cpp:24-41``, ``SlamWrapper::startWorkers``).
Here one worker thread drains the wrapper's buffers, running its stages in
the order ``SlamWrapper.process_queued`` runs them, while the caller ingests
scans; so with no scan dropped the poses are those of the sequential replay.

On the card the worker launches every kernel, on its own current stream (the
default stream, as for every thread that sets none); the caller's thread only
copies scans to the card, and not while the worker captures a CUDA graph of
a Gauss-Newton loop (``gn_graph.capturing``).  An error in the worker is
raised again at the next ``add_range_scan`` and at ``stop_workers``; it is
never swallowed.

Offline replay should call ``SlamWrapper.process_scan_pipelined`` directly.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.ops import gn_graph

_JOIN_TIMEOUT_SEC = 60.0    # the worker finishes the scan it holds first


class AsyncSlamDriver:
    def __init__(self, slam: SlamWrapper, poll_sleep_sec: float = 0.001):
        self.slam = slam
        self.poll_sleep_sec = poll_sleep_sec
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._error: Optional[Exception] = None

    def start_workers(self):
        """``startWorkers`` (``SlamWrapper.cpp:227-236``)."""
        if self._running:
            return
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="slam-pipeline")
        self._worker.start()

    def _run(self):
        try:
            while self._running:
                did_odo = self.slam._odometry_step()
                did_map = self.slam._mapping_step()
                if not (did_odo or did_map):
                    time.sleep(self.poll_sleep_sec)
        except Exception as e:   # the worker's boundary: raised again by the caller
            self._error = e
            self._running = False

    def _raise_worker_error(self):
        if self._error is not None:
            raise RuntimeError("the SLAM worker thread failed") from self._error

    def add_range_scan(self, points: np.ndarray, timestamp: float) -> bool:
        """Ingest without waiting for processing; drops an out-of-order scan
        as the wrapper does.  A full buffer drops its oldest scan: callers
        that must keep every scan wait while ``is_backpressured``."""
        self._raise_worker_error()
        with gn_graph.capturing:
            return self.slam.add_range_scan(points, timestamp)

    def is_backpressured(self) -> bool:
        """Either buffer full (``RosbagRangeDataProcessorRos.cpp:69-84``)."""
        return self.slam.is_odometry_buffer_full() or self.slam.is_mapping_buffer_full()

    def stop_workers(self, finish: bool = True):
        """``stopWorkers``, then ``finishProcessing`` unless ``finish`` is
        False.  The scan the worker holds is processed to its end first."""
        self._running = False
        if self._worker is not None:
            self._worker.join(timeout=_JOIN_TIMEOUT_SEC)
            if self._worker.is_alive():
                raise RuntimeError(f"the SLAM worker thread did not stop within "
                                   f"{_JOIN_TIMEOUT_SEC} s")
            self._worker = None
        self._raise_worker_error()
        if finish:
            self.slam.finish_processing()

    def __enter__(self):
        self.start_workers()
        return self

    def __exit__(self, *exc):
        self.stop_workers(finish=exc[0] is None)
