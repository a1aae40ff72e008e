"""The harness's shared parts: finding a cell's files by name, the window
statistics, the layer spans, the reading of the profiler's trace, and the
result line.

Nothing here imports the program when it is imported; the profiled half
reads the program's launch counter and kernel sources while a run is traced.
"""
from __future__ import annotations

import bisect
import collections
import ctypes
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "open3d_slam_tpu")


# ---------------------------------------------------------------------------
# Files found by name


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration's entry and the parsed
    configuration, traffic and checks files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "config_entry": config,
        "config": load_json(os.path.join(ROOT, config["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        "checks": load_json(os.path.join(HERE, "checks", workload + ".json")),
    }


def generator(traffic: dict) -> Callable:
    """The traffic mix's generator, ``<module>.<function>`` under
    ``perfbench/generators``."""
    mod, fn = traffic["generator"].rsplit(".", 1)
    return getattr(importlib.import_module(f"perfbench.generators.{mod}"), fn)


def runner(config: dict):
    """The configuration's runner, ``perfbench/runners/<name>.py``."""
    return importlib.import_module(f"perfbench.runners.{config['runner']}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a metric without ``workloads`` goes
    to every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


# ---------------------------------------------------------------------------
# Window statistics: over every sample of the window, never over chunks.


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of all ``values`` (linear between order
    statistics, numpy's default)."""
    if len(values) == 0:
        raise ValueError("no samples in the window")
    return float(np.percentile(np.asarray(values, np.float64), 95))


def per_second(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("the window has no length")
    return count / seconds


# ---------------------------------------------------------------------------
# Layer spans


class StageTimer:
    """Replaces functions with timed versions while active (the copy of
    ``open3d_slam_torch/cli/profile_replay.py``'s ``StageTimer``).  With
    ``sync`` each call is bracketed by ``torch.cuda.synchronize`` and timed
    on the host clock, so a span holds its own device work; a span nested
    in another is subtracted from its parent to give the parent's self
    time.  Without ``sync`` each call is only a ``torch.profiler`` range of
    its label, which adds no synchronisation: the profiled half reads from
    it what the host was doing while the device idled.  ``sync`` is the
    device's synchronisation (a no-op on the CPU)."""

    def __init__(self, torch, sync: Optional[Callable[[], None]]):
        self.torch, self.sync = torch, sync
        self.ms = collections.defaultdict(float)
        self.self_ms = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._patched = []
        self._stack: List[str] = []

    def wrap(self, owner, attr: str, label_of: Callable[..., str]):
        fn = getattr(owner, attr)
        torch = self.torch

        sync = self.sync
        if sync is not None:
            def timed(*args, **kwargs):
                label = label_of(*args)
                sync()
                t = time.perf_counter()
                self._stack.append(label)
                try:
                    out = fn(*args, **kwargs)
                finally:
                    self._stack.pop()
                sync()
                ms = (time.perf_counter() - t) * 1e3
                self.ms[label] += ms
                self.self_ms[label] += ms
                if self._stack:
                    self.self_ms[self._stack[-1]] -= ms
                self.calls[label] += 1
                return out
        else:
            def timed(*args, **kwargs):
                with torch.profiler.record_function("layer:" + label_of(*args)):
                    return fn(*args, **kwargs)

        self._patched.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self._patched):
            setattr(owner, attr, fn)
        self._patched = []

    def spans(self) -> Dict[str, dict]:
        return {k: {"ms": self.ms[k], "self_ms": self.self_ms[k], "calls": self.calls[k]}
                for k in sorted(self.ms)}


# ---------------------------------------------------------------------------
# The program's hand-written kernels and their launches


_GLOBAL = re.compile(r"__global__\s+void\s+(\w+)")
_BOUNDS = re.compile(r"__launch_bounds__\s*\([^)]*\)")
_COUNTED = re.compile(r"count_launch\(\s*\"(\w+)\"")


def hand_written_kernels(package_dir: str) -> set:
    """Names of the ``__global__`` functions in the program's ``csrc``,
    read from its sources at run time."""
    names = set()
    csrc = os.path.join(package_dir, "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                names.update(_GLOBAL.findall(_BOUNDS.sub("", fh.read())))
    return names


def short_kernel_name(key: str) -> str:
    """``void nn::(anonymous namespace)::kth_sweep<32>(...)`` -> ``kth_sweep``
    (as ``chip_smoke.launch_us`` shortens them, template arguments off)."""
    key = re.sub(r"\(anonymous namespace\)::", "", key)
    return re.sub(r"<.*$", "", key.split("(")[0].split("::")[-1].split(" ")[-1])


def mangled_short_name(name: str) -> str:
    """A kernel's function name from its mangled symbol, as a CUDA graph's
    kernel node names it (``_ZN2nn12_GLOBAL__N_19kth_sweepILi32EEEv...`` ->
    ``kth_sweep``); an unmangled name as it is."""
    if not name.startswith("_Z"):
        return name
    i = 3 if name.startswith("_ZL") else 2
    nested = name[i:i + 1] == "N"
    i += nested
    last = name
    while i < len(name):
        if name[i].isdigit():
            j = i
            while j < len(name) and name[j].isdigit():
                j += 1
            n = int(name[i:j])
            last, i = name[j:j + n], j + n
            if not nested:
                break
        elif nested and name[i] in "KVr":
            i += 1
        else:
            break
    return last


def keep_graph_nodes(gn_graph) -> Callable[[], None]:
    """From here on, every CUDA graph the program captures
    (``gn_graph._Graph``) keeps its ``cudaGraph_t``, and its kernel nodes are
    read through libcuda right after the capture: a dict maps each graph
    to the count of its kernel nodes by function name, with ``"<work>"`` the
    number of its kernel, copy and set nodes, kept as ``_Graph.node_counts``.  A
    graph holds every operation its capture enqueued, so its replays'
    launches are known without the profiler.  Call before the program's
    warm-up; returns what takes the patch out again."""
    nodes: Dict[int, collections.Counter] = {}
    init = gn_graph._Graph.__init__

    def kept(graph, body, stream, keep_graph=False):
        init(graph, body, stream, True)
        names = graph_node_names(graph.graph.raw_cuda_graph())
        count = collections.Counter(mangled_short_name(n) for n in names
                                    if not n.startswith("<"))
        count["<work>"] = sum(not n.startswith("<") or n in ("<1>", "<2>") for n in names)
        nodes[id(graph)] = count

    gn_graph._Graph.__init__ = kept
    gn_graph._Graph.node_counts = nodes

    def undo():
        gn_graph._Graph.__init__ = init
        del gn_graph._Graph.node_counts
    return undo


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h); v1 is its prefix."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_node_names(handle: int) -> List[str]:
    """Each node of a ``cudaGraph_t``, a child graph's nodes in its place: a
    kernel node by its function's mangled name, any other as ``<kind
    number>``."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed with CUresult {err}")

    graph = ctypes.c_void_p(handle)
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    call("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == 4:                 # CU_GRAPH_NODE_TYPE_GRAPH
            child = ctypes.c_void_p()
            call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node), ctypes.byref(child))
            names += graph_node_names(child.value)
            continue
        if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"<{kind.value}>")
            continue
        prm = _KernelNodeParams()
        err = get_params(ctypes.c_void_p(node), ctypes.byref(prm))
        if err != 0:
            raise RuntimeError(f"cuGraphKernelNodeGetParams failed with error {err}")
        func = ctypes.c_void_p(prm.func)
        if not prm.func:                    # set through a CUkernel handle
            call("cuKernelGetFunction", ctypes.byref(func), ctypes.c_void_p(prm.kern))
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), func)
        names.append(name.value.decode())
    return names


class LaunchRanges:
    """During the profiled half, puts a profiler range around each call of
    a counted kernel wrapper (each ``open3d_slam_torch.ops`` function whose
    name it passes to ``cuda_build.count_launch``, found in the modules'
    sources at run time) and around each CUDA-graph replay, and records what
    ``cuda_build.launches`` counted inside each range.  ``check`` then holds
    the profiler's device kernels against the launches the host made."""

    def __init__(self, torch, ops_pkg, cuda_build, gn_graph):
        self.torch, self.cuda_build = torch, cuda_build
        self.ranges: Dict[str, tuple] = {}
        self.graph_nodes = getattr(gn_graph._Graph, "node_counts", {})
        self._patched = []
        self._seq = 0
        for fname in sorted(os.listdir(os.path.dirname(ops_pkg.__file__))):
            if not (fname.startswith("cuda_") and fname.endswith(".py")):
                continue
            mod = importlib.import_module(f"{ops_pkg.__name__}.{fname[:-3]}")
            with open(mod.__file__) as f:
                keys = set(_COUNTED.findall(f.read()))
            for key in sorted(keys):
                if callable(getattr(mod, key, None)):
                    self._wrap_call(mod, key)
        self._wrap_replay(gn_graph._Graph)

    def _next(self) -> str:
        self._seq += 1
        return f"pb.launch.{self._seq}"

    def _diff(self, before: dict) -> collections.Counter:
        out = collections.Counter()
        for k, v in self.cuda_build.launches.items():
            if v != before.get(k, 0):
                out[k] = v - before.get(k, 0)
        return out

    def _wrap_call(self, mod, key):
        fn = getattr(mod, key)
        rf = self.torch.profiler.record_function

        def counted(*args, **kwargs):
            before = dict(self.cuda_build.launches)
            name = self._next()
            with rf(name):
                out = fn(*args, **kwargs)
            self.ranges[name] = ("call", key, self._diff(before))
            return out

        self._patched.append((mod, key, fn))
        setattr(mod, key, counted)

    def _wrap_replay(self, graph_cls):
        fn = graph_cls.replay
        rf = self.torch.profiler.record_function

        def replay(graph):
            name = self._next()
            with rf(name):
                out = fn(graph)
            self.ranges[name] = ("graph", id(graph), collections.Counter(graph.launches))
            return out

        self._patched.append((graph_cls, "replay", fn))
        graph_cls.replay = replay

    def restore(self):
        for owner, attr, fn in reversed(self._patched):
            setattr(owner, attr, fn)
        self._patched = []

    def check(self, trace: "Trace", hand_written: set, counted: collections.Counter):
        """(ok, lines).  Every launch the host made inside a counted range
        has to reach the profiler's device records, kernel by kernel name:

        - each kernel launch call (``cudaLaunchKernel``, ``cuLaunchKernel``,
          ...) inside a wrapper's range has exactly one device kernel under
          its correlation id;
        - each replay's ``cudaGraphLaunch`` has, under its correlation id,
          the graph's kernel nodes (read through libcuda after the
          capture, ``keep_graph_nodes``), name by name for the hand-written
          ones, and at least as many device operations as the graph has
          kernel, copy and set nodes (a copy or a set node may run as a
          kernel of its own);
        - the profiler ran no hand-written kernel outside those ranges;
        - ``cuda_build.launches`` counted nothing outside them.

        For each hand-written kernel the count the host's launches call for
        has to equal the count the profiler saw."""
        expected, seen = collections.Counter(), collections.Counter()
        lost, stray, unread = collections.Counter(), collections.Counter(), 0
        extra: Dict[int, collections.Counter] = {}
        by_corr = collections.defaultdict(list)
        for ev in trace.device:
            by_corr[ev[4]].append(ev)
        owned = set()
        credited = collections.Counter()
        for host_start, corrs, api, owner in trace.launch_calls():
            rec = self.ranges.get(owner)
            if rec is None:
                continue
            owned.update(corrs)
            work = [ev for c in corrs for ev in by_corr.get(c, [])]
            kernels = [ev for ev in work if ev[5] == "kernel"]
            names = collections.Counter(short_kernel_name(ev[2]) for ev in kernels)
            graph = "GraphLaunch" in api
            if rec[0] == "call" and not graph:
                if len(kernels) != 1:
                    lost[(rec[1], api, len(kernels))] += 1
                expected.update(names)
            elif rec[0] == "graph" and graph:
                nodes = self.graph_nodes.get(rec[1])
                if nodes is None:
                    unread += 1
                    continue
                named = {k: v for k, v in nodes.items() if k != "<work>"}
                expected.update(named)
                if len(work) < nodes["<work>"]:
                    lost[("graph", nodes["<work>"], len(work))] += 1
                elif len(work) > nodes["<work>"] and rec[1] not in extra:
                    extra[rec[1]] = collections.Counter(
                        short_kernel_name(ev[2])[:40] for ev in work)
                    extra[rec[1]].subtract(named)
                    extra[rec[1]] = +extra[rec[1]]
            seen.update(names)
        for name, rec in self.ranges.items():
            credited.update(rec[2])
        for ev in trace.device:
            short = short_kernel_name(ev[2])
            if ev[5] == "kernel" and short in hand_written and ev[4] not in owned:
                stray[short] += 1
        lines, ok = [], not lost and unread == 0 and not stray
        for k in sorted(k for k in set(expected) | set(seen) if k in hand_written):
            good = expected[k] == seen[k]
            ok = ok and good
            lines.append(f"launch check {k}: the host's launches call for {expected[k]}, "
                         f"the profiler saw {seen[k]}{'' if good else '  MISMATCH'}")
        for k in sorted(set(counted) | set(credited)):
            if counted[k] != credited[k]:
                ok = False
                lines.append(f"launch check: cuda_build.launches counted {counted[k]} of "
                             f"{k} over the half, the ranges {credited[k]}  MISMATCH")
        lines.append(f"launch check: {sum(counted.values())} counted wrapper launches in "
                     f"{len(self.ranges)} ranges; launch calls whose device kernels are not "
                     f"one, or a replay's fewer than its graph's nodes, by (wrapper or "
                     f"'graph', call or nodes, kernels or device operations seen): {dict(lost.most_common(8))}; "
                     f"replays of graphs whose nodes were not read {unread}; hand-written "
                     f"kernels outside every range {dict(stray)}")
        for names in list(extra.values())[:4]:
            lines.append(f"launch check: a graph's replay ran more device operations than "
                         f"its kernel, copy and set nodes (not a loss): beyond its kernel "
                         f"nodes {dict(names.most_common(6))}")
        return ok, lines


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


def _annotation(name: str) -> bool:
    return name.startswith(("pb.", "layer:"))


def _device_kind(kind, name: str) -> str:
    if kind in DEVICE_WORK:
        return kind
    return "gpu_memcpy" if name.startswith("Memcpy") else \
        "gpu_memset" if name.startswith("Memset") else "kernel"


class Trace:
    """The events of a ``torch.profiler`` trace, read once from its kineto
    results (no event tree is built): device operations with CUPTI's
    correlation id and the host time of the runtime call that launched them
    (a graph's kernels share their ``cudaGraphLaunch``'s), the host's
    launch calls, and host ranges."""

    def __init__(self, torch, prof):
        cuda = torch.autograd.DeviceType.CUDA
        device, runtime = [], {}
        self.calls = []         # (start us, end us, correlation id, name) of launch calls
        self.host = []          # (start us, end us, name) of the host ranges
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            name = e.name()
            kind = e.activity_type() if hasattr(e, "activity_type") else None
            if e.device_type() == cuda:
                # Device work only: the device timeline also mirrors the
                # host's annotations (``gpu_user_annotation``).
                if kind in DEVICE_WORK or (kind is None and not _annotation(name)):
                    device.append((start, end, name, e.correlation_id(),
                                   _device_kind(kind, name)))
            elif kind in ("cuda_runtime", "cuda_driver") or (
                    kind is None and name.startswith("cu")):
                runtime[e.correlation_id()] = start
                if name.startswith(LAUNCH_CALLS):
                    self.calls.append((start, end, e.correlation_id(), name))
            else:
                self.host.append((start, end, name))
        # (start, end, name, host launch time, correlation id, kind)
        self.device = sorted((a, b, name, runtime.get(c), c, k) for a, b, name, c, k in device)
        self.host.sort()
        self.calls.sort()

    def span_of(self, name: str):
        for a, b, n in self.host:
            if n == name:
                return a, b
        raise KeyError(f"no host range {name!r} in the trace")

    def launch_calls(self):
        """(start, correlation ids, API name, name of the ``pb.launch`` range
        the call was made in, or "none") of every launch: a runtime call
        with the libcuda call it makes inside it (CUPTI records both, each
        with its own correlation id) counts once, under the outer name."""
        ranges = [(a, b, n) for a, b, n in self.host if n.startswith("pb.launch.")]
        starts = [a for a, _, _ in ranges]
        groups = []
        for start, end, corr, api in self.calls:
            if groups and start >= groups[-1][0] and end <= groups[-1][1]:
                groups[-1][2].append(corr)
            else:
                groups.append([start, end, [corr], api])
        for start, _, corrs, api in groups:
            owner = "none"
            k = bisect.bisect_right(starts, start) - 1
            if k >= 0 and ranges[k][1] >= start:
                owner = ranges[k][2]
            yield start, corrs, api, owner


def device_profile(trace: Trace, window: tuple, hand_written: set) -> dict:
    """From the profiled half's trace: the union of the device intervals
    (busy), the device time of each kernel by name, the hand-written
    kernels' share of it, and the device's idle gaps, each credited to the
    innermost ``layer:`` range on the host at the gap's middle.  ``window``
    is the half's (start, end) in the trace's microseconds."""
    t0, t1 = window
    busy, end = 0.0, t0
    gaps = []
    by_kernel = collections.defaultdict(float)
    launches = collections.Counter()
    for a, b, name, *_ in trace.device:
        by_kernel[name] += b - a
        launches[short_kernel_name(name)] += 1
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((end, t1))
    hand_us = sum(us for name, us in by_kernel.items()
                  if short_kernel_name(name) in hand_written)
    layers = [(a, b, n[len("layer:"):]) for a, b, n in trace.host if n.startswith("layer:")]
    idle = collections.defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner, span = "host outside the layers", math.inf
        for s, e, label in layers:
            if s > mid:
                break
            if e >= mid and e - s < span:
                inner, span = label, e - s
        idle[inner] += b - a
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "busy_s": busy / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "hand_written_ms": hand_us / 1e3,
        "device_ops": [[short_kernel_name(n) if short_kernel_name(n) in hand_written else n[:80],
                        us / 1e6] for n, us in top],
        "idle_gaps": [[k, v / 1e6] for k, v in sorted(idle.items(), key=lambda kv: kv[1],
                                                      reverse=True)[:10]],
        "device_events": len(trace.device),
        "hand_written_launches": {k: n for k, n in sorted(launches.items())
                                  if k in hand_written},
    }


def profiled_half(torch, feed: Callable[[], int], wrap_layers: Callable[[StageTimer], None],
                  sync: Callable[[], None], info: List[str]) -> dict:
    """The traced window's second half: ``feed()`` under ``torch.profiler``
    with no synchronisation added, each layer's entry a ``layer:`` range
    (``wrap_layers``) and each counted kernel wrapper and graph replay a
    ``LaunchRanges`` range.  Raises unless the profiler saw every launch
    ``cuda_build.launches`` counted.  Returns the ``device_profile``, with
    the units ``feed`` returned under ``units``."""
    import open3d_slam_torch
    from open3d_slam_torch import ops
    from open3d_slam_torch.ops import cuda_build, gn_graph
    hand = hand_written_kernels(os.path.dirname(open3d_slam_torch.__file__))
    ranges = LaunchRanges(torch, ops, cuda_build, gn_graph)
    layers = StageTimer(torch, None)
    wrap_layers(layers)
    before = collections.Counter(cuda_build.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("pb.window"):
                units = feed()
                sync()
            t = time.perf_counter()
        stop_s = time.perf_counter() - t
    finally:
        layers.restore()
        ranges.restore()
    counted = collections.Counter(cuda_build.launches)
    counted.subtract(before)
    t = time.perf_counter()
    trace = Trace(torch, prof)
    profile = device_profile(trace, trace.span_of("pb.window"), hand)
    ok, lines = ranges.check(trace, hand, +counted)
    info += lines
    info.append(f"trace: {profile['device_events']} device events, read in "
                f"{time.perf_counter() - t:.1f} s after the profiler's {stop_s:.1f} s stop; "
                f"hand-written launches {profile['hand_written_launches']}")
    if not ok:
        print("\n".join(info), file=sys.stderr)
        raise RuntimeError("the profiler saw other launches of the hand-written kernels "
                           "than cuda_build.launches counted (lines above)")
    profile["units"] = units
    return profile


# ---------------------------------------------------------------------------
# The run's end


def setup_parts(t_start: float, marks) -> str:
    """The set-up's parts, each with the seconds it took."""
    parts, prev = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    return "set-up: " + ", ".join(parts)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    that a run may not load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def limit_text(check: dict) -> str:
    return f"{check['op']} {check['limit']!r}"


def passes(value: float, op: str, limit: float) -> bool:
    if op == "<=":
        return value <= limit
    if op == ">=":
        return value >= limit
    raise ValueError(f"unknown comparison {op!r}")
