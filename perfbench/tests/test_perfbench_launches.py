"""The traced run's launch check: the profiler has to show every kernel the
host launched inside a counted range, by kernel name, a graph replay's by
the graph's own kernel nodes."""
import collections

from perfbench import core

HAND = {"kth_sweep", "kth_merge", "gn_step_kernel"}
SWEEP = "void nn::(anonymous namespace)::kth_sweep<32>(float const*, int)"
MERGE = "void nn::(anonymous namespace)::kth_merge<32>(float*)"
STEP = "void gn_step_kernel(float*)"


def _trace(calls, device, ranges):
    t = object.__new__(core.Trace)
    t.calls = sorted(calls)
    t.device = sorted(device)
    t.host = sorted((a, b, n) for n, (a, b) in ranges.items())
    return t


def _check(drop=(), graph_nodes=None, extra_device=()):
    """One wrapper call that launches kth_sweep and kth_merge, and one
    replay of a graph whose nodes are two gn_step_kernel launches."""
    lr = object.__new__(core.LaunchRanges)
    lr.ranges = {"pb.launch.1": ("call", "kth_neighbor_d2_within",
                                 collections.Counter({("kth_neighbor_d2_within", (4, 4)): 1})),
                 "pb.launch.2": ("graph", 7, collections.Counter({("gn_step", (1,)): 2}))}
    nodes = {"gn_step_kernel": 2, "<work>": 2} if graph_nodes is None else graph_nodes
    lr.graph_nodes = {7: collections.Counter(nodes)}
    calls = [(1.0, 1.5, 11, "cudaLaunchKernel"), (1.1, 1.4, 21, "cuLaunchKernel"),
             (2.0, 2.5, 12, "cudaLaunchKernel"), (11.0, 11.5, 13, "cudaGraphLaunch")]
    device = [(20.0, 21.0, SWEEP, 1.0, 11, "kernel"), (22.0, 23.0, MERGE, 2.0, 12, "kernel"),
              (24.0, 25.0, STEP, 11.0, 13, "kernel"), (26.0, 27.0, STEP, 11.0, 13, "kernel"),
              *extra_device]
    device = [d for i, d in enumerate(device) if i not in drop]
    trace = _trace(calls, device, {"pb.launch.1": (0.5, 5.0), "pb.launch.2": (10.0, 12.0)})
    counted = collections.Counter({("kth_neighbor_d2_within", (4, 4)): 1, ("gn_step", (1,)): 2})
    return lr.check(trace, HAND, counted)


def test_every_launch_seen_passes():
    ok, lines = _check()
    assert ok, lines


def test_a_lost_second_kernel_of_a_wrapper_fails():
    ok, lines = _check(drop={1})
    assert not ok
    assert any("('kth_neighbor_d2_within', 'cudaLaunchKernel', 0): 1" in ln for ln in lines)


def test_a_graph_kernel_lost_in_every_replay_fails():
    ok, lines = _check(drop={3})
    assert not ok, lines


def test_a_graph_replay_with_more_device_operations_than_nodes_passes():
    ok, lines = _check(extra_device=[(28.0, 29.0, "memset_as_a_kernel", 11.0, 13, "kernel")])
    assert ok, lines
    assert any("'memset_as_a_kernel': 1" in ln for ln in lines)


def test_a_graph_whose_nodes_were_not_read_fails():
    lr_ok, _ = _check(graph_nodes={})
    assert not lr_ok


def test_a_hand_written_kernel_outside_every_range_fails():
    ok, lines = _check(extra_device=[(30.0, 31.0, SWEEP, 40.0, 99, "kernel")])
    assert not ok
    assert any("outside every range {'kth_sweep': 1}" in ln for ln in lines)


def test_mangled_kernel_names_shorten_as_the_profiler_names_them():
    for mangled, short in [("_ZN2nn12_GLOBAL__N_19kth_sweepILi32EEEvPKfPKiS2_", "kth_sweep"),
                           ("_Z9gicp_rowsPKfS0_", "gicp_rows"),
                           ("_ZN12_GLOBAL__N_114gn_step_kernelEPf", "gn_step_kernel"),
                           ("_Z9kth_mergeILi32EEvPf", "kth_merge"),
                           ("plain_c_kernel", "plain_c_kernel")]:
        assert core.mangled_short_name(mangled) == short
    assert core.short_kernel_name(SWEEP) == "kth_sweep"
