"""The join of the program's spans with the device trace, on planted
recordings and traces: a gap is credited to the innermost span at its
middle and a pull's to its parent's layer; a shifted clock fails the clock
check; each reader of the join returns None on a trace without it."""
import collections

import pytest

from open3d_slam_torch.utils.timeutil import Recording, Span
from perfbench import core, program_spans

# One scan, in microseconds on the Unix clock: the root, the odometry
# dispatch with a GN loop and its pull inside, the mapper's finalize with
# its pull, and a closure phase.
US = [("slam_wrapper.scan", 100, 1000, -1), ("odometry.scan", 110, 400, 0),
      ("gn_loop.gicp", 200, 390, 1), ("pull", 300, 380, 2),
      ("mapper.finalize", 420, 700, 0), ("pull", 430, 600, 4),
      ("closure.advance", 720, 900, 0), ("closure.ransac", 730, 880, 6)]
WINDOW = (0.0, 1200.0)


def _recording(shift_us=0.0, counters=None):
    spans = [Span(n, int((a + shift_us) * 1e3), int((b + shift_us) * 1e3), p, 0, "MainThread")
             for n, a, b, p in US]
    counters = counters or {("gn_loop.gicp", "pulls"): 1, ("mapper.finalize", "pulls"): 1,
                            ("closure.start", "closure.jobs_started"): 2,
                            ("optimization.round", "closure.jobs_with_constraints"): 1,
                            ("gn_loop.gicp", "graph_replays"): 2}
    return Recording(spans, counters, 0, 250)


# Device work: 0-150, 250-350 (inside the GN loop), 610-650, 1100-1150.
DEVICE = [(0.0, 150.0, "k", None, 1, "kernel"), (250.0, 350.0, "k", None, 2, "kernel"),
          (610.0, 650.0, "k", None, 3, "kernel"), (1100.0, 1150.0, "k", None, 4, "kernel")]
# The harness's launch ranges: two wrapper calls and a graph replay.
HOST = [(205.0, 240.0, "pb.launch.1"), (250.0, 260.0, "pb.launch.2"),
        (640.0, 660.0, "pb.launch.3")]
REPLAYS = {"pb.launch.2"}


def _read(rec):
    return program_spans.read(rec, DEVICE, HOST, WINDOW, REPLAYS)


def test_the_gaps_are_those_of_device_profile():
    trace = object.__new__(core.Trace)
    trace.device, trace.host = sorted(DEVICE), []
    gaps = program_spans.idle_gaps(trace.device, WINDOW)
    assert gaps == [(150.0, 250.0), (350.0, 610.0), (650.0, 1100.0), (1150.0, 1200.0)]
    prof = core.device_profile(trace, WINDOW, set())
    assert sum(b - a for a, b in gaps) / 1e6 == pytest.approx(
        prof["window_s"] - prof["busy_s"])


def test_a_gap_is_credited_to_the_innermost_span_at_its_middle():
    p = _read(_recording())
    # 150-250 (mid 200): gn_loop.gicp; 350-610 (mid 480): the finalize's
    # pull, the mapper's; 650-1100 (mid 875): closure.ransac; 1150-1200:
    # no span.
    assert p["idle_s_by_span"] == pytest.approx({
        "gn_loop.gicp": 100e-6, "mapper.finalize/pull": 260e-6,
        "closure.ransac": 450e-6, program_spans.NO_SPAN: 50e-6})
    assert p["idle_s_by_layer"] == pytest.approx({
        "gn_loop": 100e-6, "mapper": 260e-6, "closure": 450e-6,
        program_spans.NO_SPAN: 50e-6})
    assert p["idle_s"] == pytest.approx(860e-6)
    assert p["pulls_by_span"] == {"gn_loop.gicp": 1, "mapper.finalize": 1}
    assert p["pull_wait_ms_by_span"] == pytest.approx({"gn_loop.gicp": 0.08,
                                                        "mapper.finalize": 0.17})
    assert p["scans"] == 1
    assert p["closure_ms_in_slow_scans"] == pytest.approx(0.18)
    assert p["host_self_ms_by_span"]["slam_wrapper.scan"] == pytest.approx(
        (900 - 290 - 280 - 180) / 1e3)
    assert p["clock"] == {"launch_ranges": 3, "launch_share": 1.0, "replays": 1,
                          "replay_share": 1.0, "drift_ns": 250}
    program_spans.check_clock(p)
    lines = program_spans.info_lines(p)
    assert any("clock check" in line for line in lines)


def test_the_spans_beside_the_harness_layer_ranges():
    # The harness's ranges around the root, the odometry dispatch and the GN
    # loop, each 2 us wider than the span its function opens, but the GN
    # loop's starts 60 us early: the gap at 150-230 (mid 190) falls in it
    # for the harness and in the odometry dispatch for the program.
    layers = [(98.0, 1002.0, "layer:slam_wrapper"), (108.0, 402.0, "layer:odometry"),
              (140.0, 392.0, "layer:gn_loop")]
    device = [(0.0, 150.0, "k", None, 1, "kernel"), *DEVICE[1:]]
    device[1] = (230.0, 350.0, "k", None, 2, "kernel")
    p = program_spans.read(_recording(), device, sorted(HOST + layers), WINDOW, REPLAYS)
    got = p["against_layers"]
    assert got["alignment"] == {
        "gn_loop": {"pairs": 1, "start_lag_us": [60.0, 60.0], "end_lead_us": [2.0, 2.0]},
        "odometry": {"pairs": 1, "start_lag_us": [2.0, 2.0], "end_lead_us": [2.0, 2.0]},
        "slam_wrapper": {"pairs": 1, "start_lag_us": [2.0, 2.0], "end_lead_us": [2.0, 2.0]}}
    assert got["offset_bracket_us"] == [-2.0, 2.0]
    assert got["moved"] == [["slam_wrapper", "closure.ransac", pytest.approx(450e-6)],
                            ["slam_wrapper", "mapper.finalize/pull", pytest.approx(260e-6)],
                            ["gn_loop", "odometry.scan", pytest.approx(80e-6)]]
    assert _read(_recording())["against_layers"] is None


def test_the_innermost_span_of_nested_and_disjoint_spans():
    spans = [(0, 10, "a", -1), (2, 5, "b", 0), (3, 4, "c", 1), (6, 9, "d", 0), (20, 30, "e", -1)]
    got = program_spans.innermost(spans, [1, 3.5, 4.5, 5.5, 7, 15, 25, 31])
    assert [s[2] if s else None for s in got] == ["a", "c", "b", "a", "d", None, "e", None]


def test_a_shifted_clock_fails_the_check():
    p = _read(_recording(shift_us=500.0))
    assert p["clock"]["launch_share"] < program_spans.CLOCK_SHARE
    with pytest.raises(RuntimeError, match="disagree"):
        program_spans.check_clock(p)
    # A replay outside every gn_loop.* or optimization.* span fails too.
    p = program_spans.read(_recording(), DEVICE, HOST, WINDOW, {"pb.launch.3"})
    assert p["clock"]["launch_share"] == 1.0 and p["clock"]["replay_share"] == 0.0
    with pytest.raises(RuntimeError):
        program_spans.check_clock(p)
    # Within the tolerance a range may stick out of its span.
    p = _read(_recording(shift_us=program_spans.TOLERANCE_US - 1))
    assert p["clock"]["launch_share"] == 1.0


NEW = ["slam_wrapper.idle_ms_per_scan", "odometry.idle_ms_per_scan", "mapper.idle_ms_per_scan",
       "submap.idle_ms_per_scan", "gn_loop.idle_ms_per_scan", "closure.idle_ms_per_scan",
       "slam_wrapper.pull_wait_ms_per_scan", "gn_loop.host_syncs_per_scan",
       "closure.ms_in_slow_scans", "closure.accepted_share"]


@pytest.mark.parametrize("name", NEW)
def test_each_reader_returns_none_without_the_join(name):
    read = core.metric_reader(name)
    base = {"kind": "mapping", "spans": {}, "synced_scans": 3, "profiled_scans": 4,
            "host_syncs": 20, "profile": {"busy_s": 1.0, "window_s": 2.0}}
    assert read(base) is None
    assert read({**base, "program": None}) is None
    assert read({"kind": "relocalize", "program": _read(_recording())}) is None


def test_the_readers_on_a_planted_join():
    trace = {"kind": "mapping", "profiled_scans": 2, "program": _read(_recording())}
    got = {n: core.metric_reader(n)(trace) for n in NEW}
    assert got == pytest.approx({
        "slam_wrapper.idle_ms_per_scan": 0.0, "odometry.idle_ms_per_scan": 0.0,
        "mapper.idle_ms_per_scan": 0.13, "submap.idle_ms_per_scan": 0.0,
        "gn_loop.idle_ms_per_scan": 0.05, "closure.idle_ms_per_scan": 0.225,
        "slam_wrapper.pull_wait_ms_per_scan": 0.125, "gn_loop.host_syncs_per_scan": 0.5,
        "closure.ms_in_slow_scans": 0.18, "closure.accepted_share": 0.5})
    none_started = {"kind": "mapping", "profiled_scans": 2, "program": _read(
        _recording(counters={("gn_loop.gicp", "pulls"): 3}))}
    assert core.metric_reader("closure.accepted_share")(none_started) is None
    assert core.metric_reader("gn_loop.host_syncs_per_scan")(none_started) == 1.5


def test_without_a_recording_there_is_no_join():
    assert program_spans.read(None, DEVICE, HOST, WINDOW, REPLAYS) is None
    counts = collections.Counter()
    assert program_spans.closure_ms_in_slow_scans([]) is None and not counts
