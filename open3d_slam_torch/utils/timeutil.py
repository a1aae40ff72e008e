"""Time types, timers and the stage telemetry registry.

Port of ``open3d_slam_tpu.utils.timeutil``: the reference's
Cartographer-style universal time scale (``time.hpp:41-55``), an int64
count of 100 ns ticks since year 1, and its ``Timer`` stopwatch.  The JAX
package times a stage on the host and, on sampled invocations, blocks on the
stage's device arrays so the host clock covers the device work.  Here every timed stage on a CUDA
device records a CUDA event at its start and its end instead: the elapsed
time between the two events is the device time the stage's queued work
spans, and reading it never blocks the replay (events are resolved only once
the card reports them complete).  On the CPU the host clock is the measure.
"""
from __future__ import annotations

import sys as _sys
import time as _time
from typing import Dict, List, Optional, Tuple

import torch

# 100 ns ticks per second, as the reference's universal time scale.
TICKS_PER_SECOND = 10_000_000
# Seconds from year 1 to the Unix epoch (719162 days, as Cartographer).
EPOCH_OFFSET_SECONDS = 719_162 * 24 * 3600


def from_seconds(seconds: float) -> int:
    """Seconds (a duration) -> ticks."""
    return int(round(seconds * TICKS_PER_SECOND))


def to_seconds(ticks: int) -> float:
    """Ticks (a duration) -> seconds."""
    return ticks / TICKS_PER_SECOND


def from_unix_seconds(unix_seconds: float) -> int:
    """Unix timestamp -> universal time (ticks since year 1)."""
    return int(round((unix_seconds + EPOCH_OFFSET_SECONDS) * TICKS_PER_SECOND))


def to_unix_seconds(t: int) -> float:
    return t / TICKS_PER_SECOND - EPOCH_OFFSET_SECONDS


class Timer:
    """Stopwatch with running average (reference ``Timer``); on a CUDA
    device the measurement is the device time between two events."""

    def __init__(self, name: str = "", device: Optional[torch.device] = None):
        self.name = name
        self.device = device
        self._start = None
        self._start_event = None
        self._total_ms = 0.0
        self._count = 0
        self._open: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.recording = True

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def start(self):
        self._start = _time.perf_counter()
        if self.recording and self._cuda():
            self._start_event = torch.cuda.Event(enable_timing=True)
            self._start_event.record()

    def elapsed_ms(self) -> float:
        """Host milliseconds since ``start``."""
        return (_time.perf_counter() - self._start) * 1e3

    def add_measurement_ms(self, ms: float):
        self._total_ms += ms
        self._count += 1

    def stop(self) -> float:
        ms = self.elapsed_ms()
        if self.recording:
            if self._cuda():
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._open.append((self._start_event, end))
            else:
                self.add_measurement_ms(ms)
        self._start = None
        return ms

    def resolve(self):
        """Fold in the event pairs the card has completed (non-blocking)."""
        still = []
        for s, e in self._open:
            if e.query():
                self.add_measurement_ms(s.elapsed_time(e))
            else:
                still.append((s, e))
        self._open = still

    @property
    def avg_ms(self) -> float:
        return self._total_ms / self._count if self._count else 0.0

    @property
    def count(self) -> int:
        return self._count

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class TelemetryRegistry:
    """Named stage timers + periodic stats printing (the reference's 15 s
    telemetry prints, ``SlamWrapper.cpp:282-286``)."""

    def __init__(self, print_every_sec: float = 15.0, enabled: bool = True,
                 sample_every: int = 32, device: Optional[torch.device] = None):
        self.timers: Dict[str, Timer] = {}
        self.print_every_sec = print_every_sec
        self.enabled = enabled
        self.sample_every = max(1, int(sample_every))
        self.device = device
        self._invocations: Dict[str, int] = {}
        self._last_print = _time.monotonic()

    def timer(self, name: str, sampled: bool = False) -> Timer:
        """``sampled=True`` for hot per-scan stages (record 1 of every
        ``sample_every`` invocations)."""
        if name not in self.timers:
            self.timers[name] = Timer(name, self.device)
        t = self.timers[name]
        n = self._invocations.get(name, 0)
        self._invocations[name] = n + 1
        t.recording = self.enabled and (not sampled or n % self.sample_every == 0)
        return t

    def sync(self, x):
        """Wait for the device work queued so far on the device of each
        tensor in ``x`` (a tensor, or a tuple, list or dict of tensors), only
        when telemetry is on; returns ``x``.  The JAX package's ``sync``
        blocks on a stage's arrays so that its host timer covers the device
        work.  The port's stage timers do that job without blocking: on the
        card each records a CUDA event at its start and end.  ``sync`` is
        kept for a caller that reads the host clock around a stage."""
        if not self.enabled:
            return x
        leaves = x.values() if isinstance(x, dict) else (
            x if isinstance(x, (tuple, list)) else (x,))
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                torch.cuda.current_stream(t.device).synchronize()
        return x

    def maybe_print(self, force: bool = False):
        if not self.enabled:
            return
        now = _time.monotonic()
        if force or now - self._last_print >= self.print_every_sec:
            for name, t in sorted(self.timers.items()):
                t.resolve()
                if t.count:
                    hz = 1000.0 / t.avg_ms if t.avg_ms > 0 else 0.0
                    print(f"[o3d_slam_torch] {name}: avg {t.avg_ms:.1f} ms, "
                          f"{hz:.1f} Hz, n={t.count}", file=_sys.stderr)
            self._last_print = now
