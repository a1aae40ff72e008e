"""The registration loops kept on the card: CUDA graphs.

The JAX package runs each ICP loop (``registration._icp_gicp_fused_batch``,
``_icp_p2l_fused_batch``, ``icp_point_to_point``) as one ``lax.while_loop``:
one compiled program that returns to the host once per registration.  The
port's counterpart is a handful of ``torch.cuda.CUDAGraph``s per loop shape,
captured once and replayed for every call:

- the start, the state at the initial poses (``k = 0``);
- a chunk of ``DONE_CHECK_EVERY`` iterations, between whose replays the
  host reads ``done`` once, through the counted ``pull_bool``;
- a remainder chunk of ``max_iterations % DONE_CHECK_EVERY`` iterations,
  so that no loop runs past its limit.

A loop is a state (any ``NamedTuple`` of tensors with a ``done`` field:
``GNState`` for the Gauss-Newton loops of K1 and K4,
``registration.P2PState`` for point-to-point ICP) and two functions the
caller builds from a dict of input tensors: ``start()`` gives the first
state and ``step(state)`` one iteration (``registration._gn_start``,
``_gn_iteration``, ``_p2p_program``).  ``drive`` runs them in chunks for
both paths, so the eager loop (the CPU, a ``group``, ``MODE = "eager"``)
and the graphs share the iteration's math and read ``done`` after the same
iterations.

``run`` keeps, per key (everything that fixes the captured work: the loop
kind, the shapes, the retraction, the device, the sweep's tile and split
counts, the correspondence distance and the convergence thresholds), static
buffers for the inputs and the state (laid out as the first start's own
tensors, so with the strides the eager loop's tensors have) and the graphs
that read and write them.  A call copies its inputs in (``copy_``), replays
the start and the chunks, and clones the result out, so the next call
cannot overwrite a result already returned.

Capture (``_Graph``) runs on a side stream, after one start and one step
there (the warm-up torch's graph docs prescribe): the kernels' scratch
(``nn_layout.scratch``, keyed by device and stream) and cuBLAS's workspace
for that stream exist before capture, so nothing is allocated or filled by
the graph but its own intermediates.  The warm-up's launches are real and
counted; the capture's are recorded (``cuda_build.graph_launches``) and
credited at each replay.  The graph holds the scratch it was captured with,
which its kernels leave as they found it (keys all ones, tickets zero).
Capture uses ``capture_error_mode="thread_local"``: the online driver
registers on its worker thread while the caller's thread copies scans in.
Even so, a host-to-device copy that another thread issues during a capture
crashed torch (a segfault at ``capture_end``, on the card's torch 2.11), so
warm-up and capture hold ``capturing``, which the online driver's ingest
holds too.  A capture or replay that fails raises; nothing falls back to
the eager loop.  A failed capture leaves the calling thread on its own
streams and retires the side stream (``_Graph``).

A program of fixed length, with no ``done`` to read (the pose-graph solve:
two LM stages of ``max_iterations`` steps, as the JAX package's
``lax.scan``s; the scan preprocess chain, ``odometry.preprocess_chain``),
goes through ``run_program``: static input and output
buffers per key, one warm-up run and then one graph of the whole program
that writes the output buffers, cloned out at each call.

``MODE`` selects the path: ``"graph"`` (the default: CUDA tensors replay
graphs, others run the eager loop), ``"eager"`` (the eager loop everywhere:
tests and ``chip_smoke.py``'s A/B) or ``"static"`` (the static buffers with
an eager runner on any device: the copy-in and clone-out tested on the
CPU).  Nothing on the main path sets it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Hashable, List, NamedTuple, Tuple

import torch

from open3d_slam_torch.ops import cuda_build, nn_layout
from open3d_slam_torch.utils.device import pull_bool
from open3d_slam_torch.utils.timeutil import telemetry

DONE_CHECK_EVERY = 4
MODE = "graph"

_entries: Dict[Hashable, "_Loop"] = {}
_lock = threading.Lock()
# Held while a graph is warmed up and captured; a thread that puts work on
# the card beside a loop on another thread holds it for that work.
capturing = threading.Lock()
_streams: Dict[torch.device, torch.cuda.Stream] = {}


class GNState(NamedTuple):
    T: torch.Tensor      # (B, 4, 4) poses the statistics were taken at
    P: torch.Tensor      # (B, 4, 4) poses the next sweep evaluates (T where done)
    fit: torch.Tensor    # (B,) fitness at T
    rmse: torch.Tensor   # (B,) inlier RMSE at T
    it: torch.Tensor     # (B,) int32 iterations taken
    done: torch.Tensor   # (B,) bool converged (frozen)


# A loop state: a NamedTuple of tensors with a ``done`` field.
State = Tuple[torch.Tensor, ...]
Program = Tuple[Callable[[], State], Callable[[State], State]]


def chunk_lengths(max_iterations: int) -> List[int]:
    """The iterations of each chunk: whole chunks of ``DONE_CHECK_EVERY``,
    then the remainder."""
    whole, rest = divmod(max_iterations, DONE_CHECK_EVERY)
    return [DONE_CHECK_EVERY] * whole + ([rest] if rest else [])


def steps(step: Callable[[State], State], state: State, k: int) -> State:
    for _ in range(k):
        state = step(state)
    return state


def drive(start: Callable[[], State], chunk: Callable[[State, int], State],
          max_iterations: int) -> State:
    """The loop: ``start()``, then ``chunk(state, k)`` for each chunk, with a
    counted read of ``done`` after every whole chunk (a converged element is
    frozen, so iterations past its convergence change nothing)."""
    state = start()
    for k in chunk_lengths(max_iterations):
        state = chunk(state, k)
        if k == DONE_CHECK_EVERY and pull_bool(state.done.all()):
            break
    return state


def uses_static_buffers(device: torch.device) -> bool:
    """Whether a loop without a group on ``device`` goes through ``run``."""
    return MODE == "static" or (MODE == "graph" and device.type == "cuda")


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


class _Eager:
    """A chunk run as it is, on the static buffers."""

    def __init__(self, body: Callable[[], None]):
        self.replay = body


def _retire(stream: torch.cuda.Stream):
    """Stop using ``stream`` for captures: the next capture on its device
    starts on a fresh side stream, with fresh kernel scratch."""
    if _streams.get(stream.device) is stream:
        del _streams[stream.device]
    nn_layout.drop_scratch(stream.device, stream.cuda_stream)


class _Graph:
    """A chunk captured into a CUDA graph on the side stream.

    A capture that fails raises from ``capture_end`` inside
    ``torch.cuda.graph.__exit__``, which then never leaves the side stream
    (torch restores the caller's stream only after a capture that ended),
    never ends the routing of allocations to the graph's private pool and
    never releases that pool.  So on failure this restores the caller's
    current streams, ends the routing, releases the pool, retires the side
    stream and raises again."""

    def __init__(self, body: Callable[[], None], stream: torch.cuda.Stream,
                 keep_graph: bool = False):
        # keep_graph: the cudaGraph_t stays readable (``raw_cuda_graph``).
        self.graph = torch.cuda.CUDAGraph(keep_graph=True) if keep_graph else \
            torch.cuda.CUDAGraph()
        # The caller's current streams, on the current device and on the
        # capture's, as torch.cuda.stream saves them.
        callers = (torch.cuda.current_stream(), torch.cuda.current_stream(stream.device))
        pool = torch.cuda.graph_pool_handle()
        with cuda_build.graph_launches() as counts:
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    body()
            except BaseException:
                if torch.cuda.current_stream(stream.device) == stream:
                    # capture_end raised: nothing of the capture was undone.
                    torch.cuda.set_stream(callers[1])
                    torch.cuda.set_stream(callers[0])
                    for release in (torch._C._cuda_endAllocateToPool,
                                    torch._C._cuda_releasePool):
                        try:
                            release(stream.device.index, pool)
                        except RuntimeError:    # ended, or never begun
                            pass
                _retire(stream)
                raise
        self.launches = counts

    def replay(self):
        self.graph.replay()
        cuda_build.credit(self.launches)
        telemetry.count("graph_replays")


class _Loop:
    """One key's static buffers and the chunks that run on them."""

    def __init__(self, inputs: Dict[str, torch.Tensor],
                 program: Callable[[Dict[str, torch.Tensor]], Program], capture: bool):
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=v.device)
                       for k, v in inputs.items()}
        self.load(inputs)
        self.start, self.step = program(self.inputs)
        self.capture = capture
        self.runs: Dict[int, object] = {}
        self.stream = self.scratch = None
        if capture:
            self.stream = _side_stream(self.inputs["inits"].device)
            with capturing:
                first = self._warm_up()
        else:
            first = self.start()
        # The state's buffers have the layout of the start's own tensors, so
        # the graphs see the strides the eager loop's tensors have.
        self.state = type(first)(*(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                       device=t.device) for t in first))

    def load(self, inputs: Dict[str, torch.Tensor]):
        for k, v in inputs.items():
            self.inputs[k].copy_(v)

    def _body(self, k: int) -> Callable[[], None]:
        def body():
            new = self.start() if k == 0 else steps(self.step, self.state, k)
            for buf, v in zip(self.state, new):
                buf.copy_(v)
        return body

    def _warm_up(self) -> State:
        """One start and one step on the side stream, on the inputs just
        loaded, before the first capture; returns the start's state."""
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            first = self.start()
            self.step(first)
        main.wait_stream(self.stream)
        b, m = self.inputs["inits"].shape[0], self.inputs["points"].shape[-2]
        self.scratch = nn_layout.scratch(self.stream.device, self.stream.cuda_stream, b, m)
        return first

    def prepare(self, k: int):
        """The runner of a chunk of ``k`` iterations (0: the start), captured
        at its first use."""
        if k not in self.runs:
            if not self.capture:
                self.runs[k] = _Eager(self._body(k))
            else:
                with capturing:
                    self.runs[k] = _Graph(self._body(k), self.stream)
        return self.runs[k]

    def run(self, k: int) -> State:
        self.prepare(k).replay()
        return self.state


def run(key: Hashable, inputs: Dict[str, torch.Tensor],
        program: Callable[[Dict[str, torch.Tensor]], Program],
        max_iterations: int) -> State:
    """The loop of ``program`` on ``inputs`` through the static buffers of
    ``key``: CUDA graphs on the card (``MODE == "graph"``), the eager runner
    otherwise.  ``inputs`` holds "inits" (B, 4, 4) and "points" (..., M, 3);
    ``program(x)`` builds ``(start, step)`` on the dict ``x`` of static
    buffers.  Returns the final state, cloned out of the buffers.  One loop
    runs at a time: a key's buffers serve every call of that key."""
    capture = MODE == "graph"
    key = (key, capture)
    with _lock:
        loop = _entries.get(key)
        if loop is None:
            loop = _Loop(inputs, program, capture)
            # Every chunk this call may need, before any replay; a key whose
            # capture failed is not kept.
            for k in (0, *chunk_lengths(max_iterations)):
                loop.prepare(k)
            _entries[key] = loop
        else:
            loop.load(inputs)
        state = drive(lambda: loop.run(0), lambda s, k: loop.run(k), max_iterations)
        return type(state)(*(t.clone() for t in state))


class _Program:
    """A fixed-length program on one key's static input and output buffers
    (laid out as the first call's inputs and the first run's outputs, so the
    program sees the strides an eager call's tensors have): one CUDA graph,
    after one warm-up run on the side stream whose launches are real and
    counted, or, without capture, the eager runner.  The graph copies its
    results into the output buffers, as a loop's chunk does into its state
    buffers."""

    def __init__(self, inputs: Dict[str, torch.Tensor],
                 program: Callable[[Dict[str, torch.Tensor]], Callable[[], Tuple]],
                 capture: bool):
        self.inputs = {k: torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                              device=v.device)
                       for k, v in inputs.items()}
        self.load(inputs)
        body = program(self.inputs)
        self.capture = capture
        if capture:
            stream = _side_stream(next(iter(self.inputs.values())).device)
            main = torch.cuda.current_stream(stream.device)
            with capturing:
                stream.wait_stream(main)
                with torch.cuda.stream(stream):
                    first = body()
                main.wait_stream(stream)
        else:
            first = body()
        self.outputs = tuple(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                 device=t.device) for t in first)

        def into_outputs():
            for buf, v in zip(self.outputs, body()):
                buf.copy_(v)

        if capture:
            with capturing:
                run = _Graph(into_outputs, stream)
        else:
            run = _Eager(into_outputs)
        self.runs = {0: run}

    def load(self, inputs: Dict[str, torch.Tensor]):
        for k, v in inputs.items():
            self.inputs[k].copy_(v)

    def run(self) -> Tuple:
        self.runs[0].replay()
        return self.outputs


def run_program(key: Hashable, inputs: Dict[str, torch.Tensor],
                program: Callable[[Dict[str, torch.Tensor]], Callable[[], Tuple]]
                ) -> Tuple:
    """A program of fixed length (no ``done`` to read: the pose-graph
    solve, the scan preprocess chain) on ``inputs`` through the static
    buffers of ``key``: one CUDA graph on the card (``MODE == "graph"``),
    the eager runner otherwise.
    ``program(x)`` builds, on the dict ``x`` of static buffers, a body that
    returns a tuple of tensors; the call returns them cloned out."""
    capture = MODE == "graph"
    key = (key, capture)
    with _lock:
        prog = _entries.get(key)
        if prog is None:
            # A key whose capture failed is not kept.
            prog = _Program(inputs, program, capture)
            _entries[key] = prog
        else:
            prog.load(inputs)
        return tuple(t.clone() for t in prog.run())


def captured() -> Tuple[int, int]:
    """(keys, CUDA graphs) captured in this process: the loops' and the
    fixed-length programs'."""
    loops = [e for e in _entries.values() if e.capture]
    return len(loops), sum(len(e.runs) for e in loops)


def clear():
    """Drop every key's buffers and graphs."""
    with _lock:
        _entries.clear()


# CUgraphNodeType (cuda.h): the kinds of node a captured graph can hold.
_NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
               "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc",
               "mem_free", "batch_mem_op", "conditional")


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h); v1 is its prefix."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        err = getattr(cu, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUDA driver error {err}")
    return cu, call


def _node_names(graph_handle: int) -> List[str]:
    """Each node of a cudaGraph_t in the order it was added: a kernel node by
    its function's (mangled) name, any other by its kind in angle brackets."""
    cu, call = _driver()
    graph = ctypes.c_void_p(graph_handle)
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:
            known = kind.value < len(_NODE_KINDS)
            names.append(f"<{_NODE_KINDS[kind.value] if known else kind.value}>")
            continue
        p = _KernelNodeParams()
        err = get_params(ctypes.c_void_p(node), ctypes.byref(p))
        if err != 0:
            raise RuntimeError(f"cuGraphKernelNodeGetParams failed with error {err}")
        func = ctypes.c_void_p(p.func)
        if not p.func:                      # set through a CUkernel handle
            call("cuKernelGetFunction", ctypes.byref(func), ctypes.c_void_p(p.kern))
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), func)
        names.append(name.value.decode())
    return names


def _clone(out):
    """``out`` with every tensor in it (in tuples too) cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        items = [_clone(v) for v in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out


def capture(fn: Callable[[], object], device: torch.device,
            keep_graph: bool = False) -> Tuple["_Graph", object]:
    """``fn`` captured into a CUDA graph as the loops capture theirs, holding
    ``capturing``: one warm-up call on the side stream (scratch and
    workspaces exist before the capture; its launches are counted), then
    the capture there (its launches recorded, credited at each
    ``replay``).  Returns (the ``_Graph``, what the captured call returned:
    tensors that each replay rewrites).  A refused capture raises, with the
    caller on its own streams (``_Graph``)."""
    out = {}
    with capturing:
        stream = _side_stream(device)
        main = torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            fn()
        main.wait_stream(stream)
        graph = _Graph(lambda: out.setdefault("result", fn()), stream, keep_graph)
    return graph, out["result"]


def graph_nodes(fn: Callable[[], object], device: torch.device) -> Tuple[List[str], object]:
    """What one call of ``fn`` puts on the card, read from a CUDA graph of
    the call (``capture``): the graph's nodes read back through the driver,
    in the order the capture added them: a kernel by its function's mangled
    name, any other node by its kind in angle brackets ("<memcpy>",
    "<memset>", ...).  The graph is then replayed once; returns (the names,
    the replay's result cloned).  Unlike a profiler's trace, which can miss
    device records, the graph holds every operation the call enqueued.  No
    launch of the warm-up, the capture or the replay stays in
    ``cuda_build.launches``, whether the capture succeeds or fails."""
    with cuda_build.launches_kept():
        graph, result = capture(fn, device, keep_graph=True)
        names = _node_names(graph.graph.raw_cuda_graph())
        graph.graph.replay()
        result = _clone(result)
        torch.cuda.current_stream(device).synchronize()
    return names, result
