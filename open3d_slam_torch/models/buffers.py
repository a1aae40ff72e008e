"""Host-side buffers: pose interpolation buffer and bounded queues.

Port of ``open3d_slam_tpu.models.buffers``.  Mirrors the reference's ``TransformInterpolationBuffer``
(``src/TransformInterpolationBuffer.cpp:21-157``) and ``CircularBuffer``
(``CircularBuffer.hpp:13-67``).  The pose buffers are read and written by
the pipeline's one thread.  ``CircularBuffer`` takes a lock: the async
driver (``models/async_driver.py``) pushes scans from the caller's thread
while its worker pops them.
"""
from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Deque, Generic, List, Optional, TypeVar

import numpy as np

import torch

from open3d_slam_torch.utils import se3

T = TypeVar("T")


class TimestampedTransform:
    __slots__ = ("time", "transform")

    def __init__(self, time: float, transform: np.ndarray):
        self.time = time
        self.transform = transform


class TransformInterpolationBuffer:
    """Time-indexed pose buffer with slerp/lerp lookup.

    Semantics follow the reference: in-order push (older measurements
    rejected), size cap dropping oldest, clamped interpolation lookup
    (``TransformInterpolationBuffer.cpp:21-43, 83-109, 149-157``).
    Times are float seconds.
    """

    def __init__(self, size_limit: int = 2000):
        self._times: List[float] = []
        self._transforms: List[np.ndarray] = []
        self.size_limit = int(size_limit)

    def __len__(self):
        return len(self._times)

    def empty(self) -> bool:
        return not self._times

    def latest_measurement(self, n_before_last: int = 0) -> TimestampedTransform:
        return TimestampedTransform(self._times[-1 - n_before_last],
                                    self._transforms[-1 - n_before_last])

    def push(self, time: float, transform: np.ndarray) -> bool:
        """Insert; returns False (ignored) if older than the newest entry."""
        if self._times and time <= self._times[-1]:
            if time == self._times[-1]:
                self._transforms[-1] = np.asarray(transform, np.float64).reshape(4, 4)
                return True
            return False
        self._times.append(float(time))
        self._transforms.append(np.asarray(transform, np.float64).reshape(4, 4))
        while len(self._times) > self.size_limit:
            self._times.pop(0)
            self._transforms.pop(0)
        return True

    def has(self, time: float) -> bool:
        return bool(self._times) and self._times[0] <= time <= self._times[-1]

    def lookup(self, time: float) -> np.ndarray:
        """Interpolated pose at ``time`` (must be inside the buffer range)."""
        if not self.has(time):
            raise KeyError(f"time {time} outside buffer "
                           f"[{self._times[0] if self._times else None}, "
                           f"{self._times[-1] if self._times else None}]")
        i = bisect.bisect_left(self._times, time)
        if i < len(self._times) and self._times[i] == time:
            return self._transforms[i].copy()
        t0, t1 = self._times[i - 1], self._times[i]
        alpha = (time - t0) / (t1 - t0)
        # Interpolated in float32, returned as float64, as the JAX package
        # does: the mapper's motion prediction reads these values.
        Ti = se3.interpolate(
            torch.as_tensor(self._transforms[i - 1], dtype=torch.float32),
            torch.as_tensor(self._transforms[i], dtype=torch.float32),
            torch.tensor(alpha, dtype=torch.float32))
        return Ti.numpy().astype(np.float64)

    def lookup_clamped(self, time: float) -> np.ndarray:
        """Clamped lookup (``getTransform``, cpp:149-157): out-of-range times
        return the earliest/latest pose."""
        if self.empty():
            raise KeyError("empty buffer")
        if time <= self._times[0]:
            return self._transforms[0].copy()
        if time >= self._times[-1]:
            return self._transforms[-1].copy()
        return self.lookup(time)


class CircularBuffer(Generic[T]):
    """Bounded deque, drop-oldest (``CircularBuffer.hpp``)."""

    def __init__(self, size_limit: int = 1):
        self._dq: Deque[T] = deque()
        self.size_limit = int(size_limit)
        self._lock = threading.Lock()

    def push(self, item: T):
        with self._lock:
            self._dq.append(item)
            while len(self._dq) > self.size_limit:
                self._dq.popleft()

    def pop(self) -> Optional[T]:
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def peek_back(self) -> Optional[T]:
        with self._lock:
            return self._dq[-1] if self._dq else None

    def __len__(self):
        with self._lock:
            return len(self._dq)

    def full(self) -> bool:
        with self._lock:
            return len(self._dq) >= self.size_limit
