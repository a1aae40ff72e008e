"""The registration loops and the fixed-length programs kept on the card:
CUDA graphs.

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
every path, so the eager loop and the graphs share the iteration's math and
read ``done`` after the same iterations.  A program of fixed length, with
no ``done`` to read (the pose-graph solve: two LM stages of
``max_iterations`` steps, as the JAX package's ``lax.scan``s; the scan
preprocess chain, ``odometry.preprocess_chain``), is the case of one run:
its body, which returns a tuple of tensors.

``run`` (loops) and ``run_program`` (fixed-length programs) are the only
entries, and they alone decide the path and the key:

- the eager path, on the caller's own tensors: ``MODE == "eager"``, tensors
  off the card under ``MODE == "graph"``, and a loop called with
  ``eager=True`` (a sharded loop, which sums over its group on every
  iteration);
- else the static buffers of the call's key: ``(name, *consts, device,
  ((input name, shape, stride, dtype) for each input))``, with ``consts``
  every constant the caller's program holds (thresholds, retraction, sizes).
  The shapes and the device fix whatever the kernels plan from them (the
  sweep's tile and split counts), so no caller keys anything itself.

A key's entry (``_Static``) holds static buffers for the inputs, each laid
out as the first call's input (``torch.empty_strided`` with its shape and
strides, so a non-contiguous input keeps its strides), and for the state or
the outputs, laid out as the first start's own tensors; and its runs, one
per chunk length (0: the start, or a program's one run), each a CUDA graph
(``MODE == "graph"``) or an eager runner on the buffers (``MODE ==
"static"``: the copy-in and clone-out tested on the CPU).  A run copies its
result into the state buffers.  A call copies its inputs in (``copy_``),
replays the runs, and clones the result out, so the next call cannot
overwrite a result already returned.  One call at a time: a key's buffers
serve every call of that key.

Capture (``_Graph``) runs on a side stream, after one start and one step
there (``_warm_up``, the warm-up torch's graph docs prescribe): the
kernels' scratch (``nn_layout.scratch``, keyed by device and stream) and
cuBLAS's workspace for that stream exist before capture, so nothing is
allocated or filled by the graph but its own intermediates.  The warm-up's
launches are real and counted; the capture's are recorded
(``cuda_build.graph_launches``) and credited at each replay.  Each graph
holds the scratch it was captured with, which its kernels leave as they
found it (keys all ones, tickets zero), whatever a later, larger call puts
in its place.  Capture uses ``capture_error_mode="thread_local"``: the
online driver registers on its worker thread while the caller's thread
copies scans in.  Even so, a host-to-device copy that another thread
issues during a capture crashed torch (a segfault at ``capture_end``, on
the card's torch 2.11), so warm-up and capture hold ``capturing``, which the
online driver's ingest holds too.  A capture or replay that fails raises;
nothing falls back to the eager loop, and a key whose capture failed is not
kept.  A failed capture leaves the calling thread on its own streams and
retires the side stream (``_Graph``).

``MODE`` selects the path: ``"graph"`` (the default), ``"eager"`` (tests
and ``chip_smoke.py``'s A/B) or ``"static"``.  Nothing on the main path
sets it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Hashable, Iterable, List, NamedTuple, Optional, Tuple

import torch

from open3d_slam_torch.ops import cuda_build, nn_layout
from open3d_slam_torch.utils.device import pull_bool
from open3d_slam_torch.utils.timeutil import telemetry

DONE_CHECK_EVERY = 4
MODE = "graph"

_entries: Dict[Hashable, "_Static"] = {}
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
Inputs = Dict[str, torch.Tensor]


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
    """Whether a call on ``device`` goes through a key's static buffers."""
    return MODE == "static" or (MODE == "graph" and device.type == "cuda")


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


def _warm_up(stream: torch.cuda.Stream, fn: Callable[[], object]):
    """``fn()`` on the side stream ``stream``, after the work the caller's
    stream holds and before what it takes next: the warm-up before a
    capture, whose launches are real and counted.  The caller holds
    ``capturing``."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn()
    main.wait_stream(stream)
    return out


class _Eager:
    """A run as it is, on the static buffers."""

    def __init__(self, body: Callable[[], None]):
        self.replay = body


def _retire(stream: torch.cuda.Stream):
    """Stop using ``stream`` for captures: the next capture on its device
    starts on a fresh side stream, with fresh kernel scratch."""
    if _streams.get(stream.device) is stream:
        del _streams[stream.device]
    nn_layout.drop_scratch(stream.device, stream.cuda_stream)


class _Graph:
    """A run captured into a CUDA graph on the side stream.

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
        # The kernel scratch the graph was captured with: a later call that
        # needs more replaces the stream's entry, not these buffers.
        self.scratch = nn_layout.held_scratch(stream.device, stream.cuda_stream)

    def replay(self):
        self.graph.replay()
        cuda_build.credit(self.launches)
        telemetry.count("graph_replays")


def _buffer(t: torch.Tensor) -> torch.Tensor:
    """A static buffer with the shape, strides, dtype and device of ``t``."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


def _map(fn: Callable[[torch.Tensor], object], out):
    """``out`` with ``fn`` applied to every tensor in it (in tuples too)."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, tuple):
        items = [_map(fn, v) for v in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out


def _device(inputs: Inputs) -> torch.device:
    return next(iter(inputs.values())).device


class _Static:
    """One key's static buffers and the runs on them.  ``program(x)`` gives
    ``(start, step)`` on the dict ``x`` of input buffers: a loop's first
    state and one iteration, or a fixed-length program's body and None."""

    def __init__(self, inputs: Inputs, program: Callable[[Inputs], Program], capture: bool):
        self.inputs = {k: _buffer(v) for k, v in inputs.items()}
        self.load(inputs)
        self.start, self.step = program(self.inputs)
        self.capture = capture
        self.runs: Dict[int, object] = {}
        self.stream: Optional[torch.cuda.Stream] = None
        if capture:
            self.stream = _side_stream(_device(self.inputs))
            with capturing:
                first = _warm_up(self.stream, self._first)
        else:
            first = self.start()
        self.state = _map(_buffer, first)

    def _first(self) -> State:
        """The start, and one step after it where there is one."""
        first = self.start()
        if self.step is not None:
            self.step(first)
        return first

    def load(self, inputs: Inputs):
        for k, v in inputs.items():
            self.inputs[k].copy_(v)

    def _body(self, k: int) -> Callable[[], None]:
        def body():
            new = self.start() if k == 0 else steps(self.step, self.state, k)
            for buf, v in zip(self.state, new):
                buf.copy_(v)
        return body

    def prepare(self, k: int):
        """The runner of a chunk of ``k`` iterations (0: the start),
        captured at its first use."""
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


def _entry(name: str, consts: tuple, inputs: Inputs,
           program: Callable[[Inputs], Program], first_runs: Iterable[int]) -> _Static:
    """The entry of the call's key, loaded with ``inputs``; at the key's
    first call, made with the runs ``first_runs`` before any replay.  The
    caller holds ``_lock``."""
    capture = MODE == "graph"
    key = ((name, *consts, _device(inputs),
            tuple((k, tuple(v.shape), v.stride(), v.dtype) for k, v in inputs.items())),
           capture)
    entry = _entries.get(key)
    if entry is None:
        entry = _Static(inputs, program, capture)
        for k in first_runs:
            entry.prepare(k)
        _entries[key] = entry
    else:
        entry.load(inputs)
    return entry


def run(name: str, consts: tuple, inputs: Inputs, program: Callable[[Inputs], Program],
        max_iterations: int, eager: bool = False) -> State:
    """The loop of ``program`` on ``inputs``: ``program(x)`` builds ``(start,
    step)`` on a dict ``x`` of tensors with the keys of ``inputs``;
    ``consts`` are the constants it holds besides them.  Returns the final
    state: on the eager path (``eager``, see the module docstring) the loop
    on ``inputs`` themselves, else the replays on the static buffers of the
    call's key, cloned out."""
    if eager or not uses_static_buffers(_device(inputs)):
        start, step = program(inputs)
        return drive(start, lambda s, k: steps(step, s, k), max_iterations)
    with _lock:
        loop = _entry(name, consts, inputs, program, (0, *chunk_lengths(max_iterations)))
        return _map(torch.clone, drive(lambda: loop.run(0), lambda s, k: loop.run(k),
                                       max_iterations))


def run_program(name: str, consts: tuple, inputs: Inputs,
                program: Callable[[Inputs], Callable[[], Tuple]]) -> Tuple:
    """A program of fixed length on ``inputs``: ``program(x)`` builds, on a
    dict ``x`` of tensors with the keys of ``inputs``, a body that returns a
    tuple of tensors; ``consts`` are the constants it holds besides them.
    Returns the body's tuple: on the eager path the body run on ``inputs``,
    else the one run on the static buffers of the call's key (a CUDA
    graph's replay on the card), cloned out."""
    if not uses_static_buffers(_device(inputs)):
        return program(inputs)()
    with _lock:
        return _map(torch.clone,
                    _entry(name, consts, inputs, lambda x: (program(x), None), (0,)).run(0))


def captured() -> Tuple[int, int]:
    """(keys, CUDA graphs) captured in this process: the loops' and the
    fixed-length programs'."""
    graphed = [e for e in _entries.values() if e.capture]
    return len(graphed), sum(len(e.runs) for e in graphed)


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
        _warm_up(stream, fn)
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
        result = _map(torch.clone, result)
        torch.cuda.current_stream(device).synchronize()
    return names, result
