"""Time types, a stopwatch, and the process-wide span recorder.

Port of ``open3d_slam_tpu.utils.timeutil``: the reference's
Cartographer-style universal time scale (``time.hpp:41-55``), an int64
count of 100 ns ticks since year 1, and its ``Timer`` stopwatch.

``telemetry`` is the program's one span recorder, module level as
``utils.device.host_syncs`` and ``ops.cuda_build.launches`` are.  Code marks
its stages with ``telemetry.span("<layer>.<stage>")`` (or ``stage``, named
under the layer of the innermost open span; ``spanned`` and ``staged``
mark a whole function) and counts events with ``telemetry.count``.  (The
``relocalize`` layer, multi-start global localization, is
``relocalize.query`` > ``.prep``, ``.coarse``, ``.rank``, ``.mid``,
``.refine``, ``.final``, with the count ``relocalize.hypotheses``.)  The
recorder is in one of three states:

  * ``OFF``: a span is one shared no-op context; no clock is read, nothing
    is allocated, no lock is taken;
  * ``STATS``: per span name a count and a total of host ns, which feed the
    reference's periodic timing print (``SlamWrapper.cpp:282-286``,
    ``is_print_timing_statistics``);
  * ``RECORDING``: besides, every span is kept (name, start, end, parent,
    scan id, thread) until ``stop_recording``.

Spans are stamped with ``time.perf_counter_ns`` and handed out on the Unix
ns clock, which ``torch.profiler``'s host events use, by one offset taken
when recording starts (its drift by the stop is reported).  Each thread
keeps its own stack of open spans and its own lists; they are merged only
when read.  A span on the host clock holds the host's time in a stage: the
device work the stage queues runs later, so only a device trace read beside
the spans says where the device waited on the host.
"""
from __future__ import annotations

import functools as _functools
import json as _json
import sys as _sys
import threading as _threading
import time as _time
from typing import Callable, Dict, List, NamedTuple, Tuple

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
    """Stopwatch with running average (reference ``Timer``), on the host
    clock."""

    def __init__(self, name: str = ""):
        self.name = name
        self._start = None
        self._total_ms = 0.0
        self._count = 0

    def start(self):
        self._start = _time.perf_counter()

    def elapsed_ms(self) -> float:
        """Host milliseconds since ``start``."""
        return (_time.perf_counter() - self._start) * 1e3

    def add_measurement_ms(self, ms: float):
        self._total_ms += ms
        self._count += 1

    def stop(self) -> float:
        ms = self.elapsed_ms()
        self.add_measurement_ms(ms)
        self._start = None
        return ms

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


OFF, STATS, RECORDING = "off", "stats", "recording"
PULL = "pull"
PRINT_EVERY_SEC = 15.0      # the reference's telemetry print period


class _NullSpan:
    """The span of the ``OFF`` state: one shared object that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


class _ThreadLog:
    """One thread's open spans, kept spans, counters and totals."""
    __slots__ = ("thread", "stack", "kept", "counters", "totals", "scan")

    def __init__(self, thread: _threading.Thread):
        self.thread = thread
        self.stack: List["_Span"] = []
        # [name, start ns, end ns (0 while open), parent record, scan id]
        self.kept: List[list] = []
        self.counters: Dict[Tuple[str, str], int] = {}
        self.totals: Dict[str, List[int]] = {}
        self.scan = -1


class _Span:
    __slots__ = ("log", "name", "layer", "record", "t0")

    def __init__(self, log: _ThreadLog, name: str, layer: str, keep: bool):
        self.log, self.name, self.layer = log, name, layer
        self.record = [name, 0, 0, None, log.scan] if keep else None

    def __enter__(self):
        log = self.log
        rec = self.record
        if rec is not None:
            if log.stack:
                rec[3] = log.stack[-1].record
            log.kept.append(rec)
        log.stack.append(self)
        self.t0 = _time.perf_counter_ns()
        if rec is not None:
            rec[1] = self.t0
        return self

    def __exit__(self, *exc):
        t1 = _time.perf_counter_ns()
        log = self.log
        stack = log.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        tot = log.totals.get(self.name)
        if tot is None:
            log.totals[self.name] = [1, t1 - self.t0]
        else:
            tot[0] += 1
            tot[1] += t1 - self.t0
        if self.record is not None:
            self.record[2] = t1
        return None


class Span(NamedTuple):
    """A kept span, on the Unix ns clock; ``parent`` indexes the
    recording's ``spans`` (-1 for a root)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    scan: int
    thread: str


class Recording(NamedTuple):
    """What ``stop_recording`` hands out: the spans, sorted by start, the
    counters by (innermost span name or "", counter name), and the offset
    from ``time.perf_counter_ns`` to the Unix ns clock at the start and at
    the stop (their difference is the clocks' drift over the recording)."""
    spans: List[Span]
    counters: Dict[Tuple[str, str], int]
    offset_ns: int
    offset_end_ns: int

    @property
    def drift_ns(self) -> int:
        return self.offset_end_ns - self.offset_ns

    def self_ns(self) -> List[int]:
        """Each span's self time: its duration less the union of its
        children's intervals (clipped to it)."""
        children: Dict[int, List[Tuple[int, int]]] = {}
        for s in self.spans:
            if s.parent >= 0:
                children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        out = []
        for i, s in enumerate(self.spans):
            covered, end = 0, s.start_ns
            for a, b in sorted(children.get(i, ())):
                a, b = max(a, end), min(b, s.end_ns)
                if b > a:
                    covered += b - a
                    end = b
            out.append(s.end_ns - s.start_ns - covered)
        return out

    def chrome_trace(self) -> dict:
        """The spans as Chrome-trace complete events (``ph: "X"``, Unix
        microseconds), with their scan id and thread in ``args``: the file
        loads beside a ``torch.profiler`` export on the same time axis."""
        tids = {}
        events = []
        for s in self.spans:
            tid = tids.setdefault(s.thread, len(tids) + 1)
            events.append({"name": s.name, "ph": "X", "cat": s.name.split(".", 1)[0],
                           "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                           "pid": 0, "tid": tid,
                           "args": {"scan": s.scan, "thread": s.thread}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock": "unix", "drift_ns": self.drift_ns,
                              "counters": [[k[0], k[1], n] for k, n in
                                           sorted(self.counters.items())]}}

    def write_chrome_trace(self, path: str):
        with open(path, "w") as f:
            _json.dump(self.chrome_trace(), f)


def unix_offset_ns() -> int:
    """Unix ns minus ``time.perf_counter_ns``, read between two Unix
    readings."""
    a = _time.time_ns()
    p = _time.perf_counter_ns()
    b = _time.time_ns()
    return (a + b) // 2 - p


class SpanRecorder:
    """The process-wide span recorder (the module's ``telemetry``)."""

    def __init__(self):
        self.state = OFF
        self._base = OFF                # the state recording returns to
        self._local = _threading.local()
        self._logs: List[_ThreadLog] = []
        self._lock = _threading.Lock()
        self._names: Dict[Tuple[str, str], str] = {}
        self._layers: Dict[str, str] = {}
        self._offset = 0
        self._last_print = _time.monotonic()

    # -- states ---------------------------------------------------------

    def use_stats(self):
        """At least ``STATS`` from now on (a recording keeps recording and
        then returns to ``STATS``)."""
        self._base = STATS
        if self.state == OFF:
            self.state = STATS

    def turn_off(self):
        """Back to ``OFF``; an open recording is dropped."""
        self.state = self._base = OFF

    def start_recording(self):
        """Keep every span and counter from now on, on every thread (what
        the threads kept before is dropped)."""
        with self._lock:
            self._logs = [g for g in self._logs if g.thread.is_alive()]
            for g in self._logs:
                g.kept = []
                g.counters = {}
        self._offset = unix_offset_ns()
        self.state = RECORDING

    def stop_recording(self) -> Recording:
        """The spans closed and the counters counted since
        ``start_recording``; the recorder returns to the state it was in."""
        if self.state == RECORDING:
            self.state = self._base
        end = unix_offset_ns()
        return self._read(self._offset, end)

    # -- the hot path ---------------------------------------------------

    def _log(self) -> _ThreadLog:
        log = getattr(self._local, "log", None)
        if log is None:
            log = self._local.log = _ThreadLog(_threading.current_thread())
            with self._lock:
                self._logs.append(log)
        return log

    def _layer(self, name: str) -> str:
        layer = self._layers.get(name)
        if layer is None:
            layer = self._layers[name] = name.split(".", 1)[0]
        return layer

    def span(self, name: str):
        """A context that marks ``name`` (``<layer>.<stage>``)."""
        if self.state == OFF:
            return NULL_SPAN
        return _Span(self._log(), name, self._layer(name), self.state == RECORDING)

    def stage(self, stage: str):
        """A span named ``<layer>.<stage>`` under the layer of the innermost
        open span (``stage`` alone outside every span): for stages that run
        under more than one layer, as the normals and the query order do."""
        if self.state == OFF:
            return NULL_SPAN
        log = self._log()
        layer = log.stack[-1].layer if log.stack else ""
        name = self._names.get((layer, stage))
        if name is None:
            name = self._names[(layer, stage)] = f"{layer}.{stage}" if layer else stage
        return _Span(log, name, layer or self._layer(stage), self.state == RECORDING)

    def spanned(self, name: str) -> Callable:
        """Decorator: each call of the function is the span ``name``."""
        def decorate(fn):
            @_functools.wraps(fn)
            def call(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return call
        return decorate

    def staged(self, stage: str) -> Callable:
        """Decorator: each call of the function is the span ``stage`` under
        the caller's layer (``stage``)."""
        def decorate(fn):
            @_functools.wraps(fn)
            def call(*args, **kwargs):
                with self.stage(stage):
                    return fn(*args, **kwargs)
            return call
        return decorate

    def pull(self):
        """The span of one blocking device->host pull, named ``pull`` and
        credited to the layer of the span it is made in."""
        if self.state == OFF:
            return NULL_SPAN
        log = self._log()
        return _Span(log, PULL, log.stack[-1].layer if log.stack else PULL,
                     self.state == RECORDING)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to counter ``name`` of the innermost open span."""
        if self.state == OFF:
            return
        log = self._log()
        key = (log.stack[-1].name if log.stack else "", name)
        log.counters[key] = log.counters.get(key, 0) + n

    def set_scan(self, scan: int):
        """The scan id the spans this thread opens from now on carry."""
        if self.state == OFF:
            return
        self._log().scan = scan

    # -- reading --------------------------------------------------------

    def _read(self, offset: int, offset_end: int) -> Recording:
        with self._lock:
            logs = list(self._logs)
        records, counters = [], {}
        for g in logs:
            name = g.thread.name
            records += [(r, name) for r in list(g.kept) if r[2]]
            for k, n in list(g.counters.items()):
                counters[k] = counters.get(k, 0) + n
        records.sort(key=lambda rt: rt[0][1])
        index = {id(r): i for i, (r, _) in enumerate(records)}
        spans = [Span(r[0], r[1] + offset, r[2] + offset,
                      index.get(id(r[3]), -1) if r[3] is not None else -1, r[4], name)
                 for r, name in records]
        return Recording(spans, counters, offset, offset_end)

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """{span name: (count, total host ms)} over every thread, since the
        process started."""
        with self._lock:
            logs = list(self._logs)
        out: Dict[str, List[float]] = {}
        for g in logs:
            for name, (n, ns) in list(g.totals.items()):
                acc = out.setdefault(name, [0, 0.0])
                acc[0] += n
                acc[1] += ns / 1e6
        return {k: (int(v[0]), v[1]) for k, v in sorted(out.items())}

    def maybe_print(self, force: bool = False):
        """Every ``PRINT_EVERY_SEC`` (or with ``force``), each span's mean
        host ms, rate and count, to stderr (the reference's telemetry
        print); nothing in the ``OFF`` state."""
        if self.state == OFF:
            return
        now = _time.monotonic()
        if force or now - self._last_print >= PRINT_EVERY_SEC:
            for name, (n, ms) in self.totals().items():
                avg = ms / n
                hz = 1000.0 / avg if avg > 0 else 0.0
                print(f"[o3d_slam_torch] {name}: avg {avg:.1f} ms, {hz:.1f} Hz, n={n}",
                      file=_sys.stderr)
            self._last_print = now


telemetry = SpanRecorder()
