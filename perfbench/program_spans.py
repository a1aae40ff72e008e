"""The program's own spans and counters (``open3d_slam_torch.utils.timeutil
.telemetry``, recorded over a traced run's profiled half) joined with the
profiler's device trace of the same half.

The program stamps its spans on ``time.perf_counter_ns`` and hands them out
on the Unix ns clock, which the profiler's host events use, so both lie on
one axis.  ``read`` credits each idle gap of the device (the gaps
``core.device_profile`` computes) to the innermost program span of the main
thread at the gap's middle, and from that span to its layer (the name's
first part; a ``pull`` span to its parent's layer).  It places the pulls and
their waits by span, and times the closure and pose-graph spans of the
half's slowest scans.  ``clock_check`` is the proof that the two clocks
agree: the harness's ``pb.launch.*`` ranges, on the profiler's own clock,
must lie inside a program span, and every graph replay's inside a
``gn_loop.*`` or ``optimization.*`` span.

Nothing here imports the program.  A program without the recorder gives
``recording`` None, and ``read`` then returns None.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAIN_THREAD = "MainThread"
NO_SPAN = "no program span"
PULL = "pull"
TOLERANCE_US = 5.0          # how far a range may stick out of its span
CLOCK_SHARE = 0.99          # the share of ranges that has to lie inside
REPLAY_LAYERS = ("gn_loop.", "optimization.")
CLOSURE_LAYERS = ("closure.", "optimization.")
TOP = 15
PAIR_US = 100.0             # how far a span may start before its layer range


def idle_gaps(device: Sequence[tuple], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The gaps between the union of the device intervals inside
    ``window`` (microseconds), as ``core.device_profile`` finds them;
    ``device`` is ``core.Trace.device``, sorted by start."""
    t0, t1 = window
    end, gaps = t0, []
    for a, b, *_ in device:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


def _us(spans) -> List[tuple]:
    """(start us, end us, name, parent, scan, thread, index) of each span."""
    return [(s.start_ns / 1e3, s.end_ns / 1e3, s.name, s.parent, s.scan, s.thread, i)
            for i, s in enumerate(spans)]


def innermost(spans: List[tuple], points: Sequence[float]) -> List[Optional[tuple]]:
    """For each time in ``points`` (ascending), the innermost of ``spans``
    (one thread's, so nested or disjoint) that holds it, or None."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, j, out = [], 0, []
    for t in points:
        while j < len(order) and order[j][0] <= t:
            while stack and stack[-1][1] < order[j][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _layer(span: tuple, spans: List[tuple]) -> str:
    name = span[2]
    if name == PULL and span[3] >= 0:
        name = spans[span[3]][2]
    return name.split(".", 1)[0]


def _key(span: tuple, spans: List[tuple]) -> str:
    """A span's name; a pull's as ``<parent>/pull``."""
    if span[2] == PULL and span[3] >= 0:
        return spans[span[3]][2] + "/" + PULL
    return span[2]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(ranges: List[Tuple[float, float]], cover: List[Tuple[float, float]]) -> int:
    """How many of ``ranges`` lie inside one interval of ``cover``
    (disjoint, sorted) within ``TOLERANCE_US``."""
    starts = [a for a, _ in cover]
    n = 0
    for a, b in ranges:
        k = bisect.bisect_right(starts, a + TOLERANCE_US) - 1
        n += k >= 0 and b <= cover[k][1] + TOLERANCE_US
    return n


def clock_check(spans_us: List[tuple], host: Sequence[tuple], replays: set) -> dict:
    """The shares of the ``pb.launch.*`` host ranges (``core.Trace.host``)
    that lie inside a program span, and of the graph replays' (the range
    names in ``replays``) that lie inside a ``gn_loop.*`` or
    ``optimization.*`` span."""
    launches = [(a, b, n) for a, b, n in host if n.startswith("pb.launch.")]
    every = _union([(s[0], s[1]) for s in spans_us])
    graph = _union([(s[0], s[1]) for s in spans_us if s[2].startswith(REPLAY_LAYERS)])
    outer = [(a, b) for a, b, n in launches]
    rep = [(a, b) for a, b, n in launches if n in replays]
    n_in, n_rep = _inside(outer, every), _inside(rep, graph)
    return {"launch_ranges": len(outer), "launch_share": n_in / len(outer) if outer else 1.0,
            "replays": len(rep), "replay_share": n_rep / len(rep) if rep else 1.0}


def read(recording, device: Sequence[tuple], host: Sequence[tuple],
         window: Tuple[float, float], replays: set) -> Optional[dict]:
    """What the recording and the trace of the profiled half say together
    (None without a recording).  ``device`` and ``host`` are
    ``core.Trace``'s, ``window`` the half's ``pb.window`` range and
    ``replays`` the names of the ``pb.launch`` ranges that are graph
    replays."""
    if recording is None:
        return None
    t0, t1 = window
    spans = _us(recording.spans)
    main = [s for s in spans if s[5] == MAIN_THREAD]
    gaps = idle_gaps(device, window)
    by_span, by_layer = collections.defaultdict(float), collections.defaultdict(float)
    mids = [0.5 * (a + b) for a, b in gaps]
    for (a, b), span in zip(gaps, innermost(main, mids)):
        key = NO_SPAN if span is None else _key(span, spans)
        layer = NO_SPAN if span is None else _layer(span, spans)
        by_span[key] += (b - a) / 1e6
        by_layer[layer] += (b - a) / 1e6
    pulls = collections.Counter()
    for (span, name), n in recording.counters.items():
        if name == "pulls":
            pulls[span or NO_SPAN] += n
    wait = collections.defaultdict(float)
    for s in spans:
        if s[2] == PULL:
            wait[spans[s[3]][2] if s[3] >= 0 else NO_SPAN] += (s[1] - s[0]) / 1e3
    counters = collections.Counter()
    for (_, name), n in recording.counters.items():
        counters[name] += n
    own = recording.self_ns()
    host_ms = collections.defaultdict(float)
    for s, ns in zip(spans, own):
        host_ms[_key(s, spans)] += ns / 1e6
    clock = clock_check(spans, host, replays)
    clock["drift_ns"] = recording.drift_ns
    return {
        "against_layers": against_layers(spans, main, host, gaps, mids),
        "window_s": (t1 - t0) / 1e6,
        "idle_s": sum(b - a for a, b in gaps) / 1e6,
        "idle_s_by_layer": dict(by_layer),
        "idle_s_by_span": dict(by_span),
        "host_self_ms_by_span": dict(host_ms),
        "pulls_by_span": dict(pulls),
        "pull_wait_ms_by_span": dict(wait),
        "counters": dict(counters),
        "scans": sum(1 for s in main if s[2] == "slam_wrapper.scan" and s[3] < 0),
        "closure_ms_in_slow_scans": closure_ms_in_slow_scans(main),
        "clock": clock,
    }


def against_layers(spans: List[tuple], main: List[tuple], host: Sequence[tuple],
                   gaps: List[Tuple[float, float]], mids: List[float]) -> Optional[dict]:
    """The program's spans beside the harness's ``layer:`` ranges of the same
    half (``core.StageTimer``), when it has them.  A layer range holds the
    program span its wrapped function opens, so the span starts after it
    and ends before it; on one clock both distances are the wrapper's own
    cost.  For each layer: the pairs found (same layer, starts and ends
    within 1 ms), the median and the least of each distance (us), and the
    offset of the profiler's clock from the program's that the least
    distances allow.  A pair is the layer's span that starts and ends
    nearest the range, within ``PAIR_US`` outside it and 1 ms inside (a
    range with no span of its own, as a closure round with no constraint
    has none, finds no pair).  ``moved`` is the idle (s) that the two credit
    to different layers, by (the harness's layer, the program's span)."""
    layers = [(a, b, n[len("layer:"):], -1) for a, b, n in host if n.startswith("layer:")]
    if not layers:
        return None
    own: Dict[str, List[tuple]] = collections.defaultdict(list)
    for sp in main:
        if sp[2] != PULL:
            own[_layer(sp, spans)].append(sp)
    lags: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for layer, cands in own.items():
        cands.sort()
        starts = [c[0] for c in cands]
        for a, b, name, _ in layers:
            if name != layer:
                continue
            k = bisect.bisect_left(starts, a)
            best = min((c for c in cands[max(k - 1, 0):k + 2]
                        if -PAIR_US < c[0] - a < 1000 and -PAIR_US < b - c[1] < 1000),
                       key=lambda c: abs(c[0] - a) + abs(b - c[1]), default=None)
            if best is not None:
                lags[layer].append((best[0] - a, b - best[1]))
    align = {}
    for layer, pairs in sorted(lags.items()):
        lag, lead = np.array(pairs).T
        align[layer] = {"pairs": len(pairs), "start_lag_us": [float(np.median(lag)),
                                                             float(lag.min())],
                        "end_lead_us": [float(np.median(lead)), float(lead.min())]}
    every = [p for pairs in lags.values() for p in pairs]
    bracket = None
    if every:
        lag, lead = np.array(every).T
        bracket = [float(-lag.min()), float(lead.min())]
    moved = collections.Counter()
    for (a, b), theirs, mine in zip(gaps, innermost(layers, mids), innermost(main, mids)):
        t = NO_SPAN if theirs is None else theirs[2]
        if t != (NO_SPAN if mine is None else _layer(mine, spans)):
            moved[(t, NO_SPAN if mine is None else _key(mine, spans))] += (b - a) / 1e6
    return {"alignment": align, "offset_bracket_us": bracket,
            "moved": [[t, m, v] for (t, m), v in moved.most_common(12)]}


def closure_ms_in_slow_scans(spans: List[tuple]) -> Optional[float]:
    """The mean, over the scans whose ``slam_wrapper.scan`` span is at or
    above the 95th percentile of them, of the time in that scan's outermost
    ``closure.*`` and ``optimization.*`` spans (ms)."""
    roots = {s[6]: s for s in spans if s[2] == "slam_wrapper.scan" and s[3] < 0}
    if not roots:
        return None
    by_index = {s[6]: s for s in spans}
    ms = collections.defaultdict(float)
    for s in spans:
        if not s[2].startswith(CLOSURE_LAYERS):
            continue
        parent, root, outermost = s[3], None, True
        while parent >= 0:
            p = by_index[parent]
            outermost = outermost and not p[2].startswith(CLOSURE_LAYERS)
            root, parent = p, p[3]
        if outermost and root is not None and root[6] in roots:
            ms[root[6]] += (s[1] - s[0]) / 1e3
    lengths = np.array([(r[1] - r[0]) / 1e3 for r in roots.values()])
    cut = float(np.percentile(lengths, 95))
    slow = [i for i, r in roots.items() if (r[1] - r[0]) / 1e3 >= cut]
    return float(np.mean([ms[i] for i in slow]))


def info_lines(program: dict) -> List[str]:
    """The run's info lines: idle by span, pulls and their wait by span,
    the idle under no program span, host self time by span, the clock
    check."""
    def top(d, scale=1.0, n=TOP):
        return {k: round(v * scale, 4) for k, v in
                sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:n]}
    idle = program["idle_s"]
    none = program["idle_s_by_layer"].get(NO_SPAN, 0.0)
    c = program["clock"]
    return [
        f"program spans: {program['scans']} scans; device idle {idle:.3f} s of "
        f"{program['window_s']:.3f} s, by layer (s) {top(program['idle_s_by_layer'])}; "
        f"under no program span {none:.4f} s ({none / idle if idle else 0.0:.4f} of the idle)",
        f"program spans: idle by span (s) {top(program['idle_s_by_span'])}",
        f"program spans: pulls by span {dict(sorted(program['pulls_by_span'].items()))}; "
        f"pull wait by span (ms) {top(program['pull_wait_ms_by_span'], n=30)}",
        f"program spans: host self time by span (ms) {top(program['host_self_ms_by_span'])}; "
        f"counters {dict(sorted(program['counters'].items()))}",
        f"program spans: clock check: {c['launch_share']:.5f} of {c['launch_ranges']} "
        f"pb.launch ranges inside a program span, {c['replay_share']:.5f} of "
        f"{c['replays']} graph replays inside a gn_loop.* or optimization.* span "
        f"(within {TOLERANCE_US} us); the clocks' offset drifted {c['drift_ns']} ns",
    ] + ([] if not program.get("against_layers") else [
        f"program spans against the harness's layer ranges: the profiler's clock less the "
        f"program's lies in {program['against_layers']['offset_bracket_us']} us; by layer "
        f"(pairs, span start after the range's [median, least] us, span end before it "
        f"[median, least] us) {program['against_layers']['alignment']}",
        f"program spans against the harness's layer ranges: idle credited to another layer, "
        f"(harness layer, program span, s) {program['against_layers']['moved']}"])


def check_clock(program: dict):
    """Raises when either share of the clock check is below
    ``CLOCK_SHARE``: crediting on misaligned clocks would be wrong without
    a sign."""
    c = program["clock"]
    if c["launch_share"] < CLOCK_SHARE or c["replay_share"] < CLOCK_SHARE:
        raise RuntimeError(f"the program's spans and the profiler's trace disagree: "
                           f"{c['launch_share']:.5f} of the launch ranges and "
                           f"{c['replay_share']:.5f} of the graph replays lie inside "
                           f"their spans (at least {CLOCK_SHARE} wanted)")


def per_scan(program: Optional[dict], scans: int, value: float) -> Optional[float]:
    return None if program is None or not scans else value / scans


def program_of(trace: dict) -> Optional[dict]:
    """The joined spans of a traced mapping run's result, if it has them."""
    if trace.get("kind") != "mapping":
        return None
    return trace.get("program")
