"""Where the time of the point-to-point Kabsch step goes, in its current
design and in its earlier one.

    python -m open3d_slam_torch.cli.p2p_split --source PATH [--cluster OTHER ...]

PATH is the earlier, one-block-a-hypothesis source of ``csrc/p2p_step.cu``
as it stood at commit 3b38a95 (``git archive 3b38a95`` unpacked under
``_archive/``, which ``.gitignore`` lists).  The tool writes cut-down
variants of each design into ``_build/split/`` (never into ``csrc/``),
cutting the kernel back one piece at a time.  The one-block design:

  launch   the launch, the stores of the partials and of dT, no point read;
  pass1    + the first streaming pass (n, sum w p, sum w q);
  tree1    + its 8-level shared-memory tree;
  pass2    + the second pass (H about the centroids);
  tree2    + its tree;
  full     + the float64 SVD on thread 0: the kernel as it was.

The cluster design (``csrc/p2p_step.cu`` as it is):

  launch   the cluster launch, the shuffles, warp and rank-order sums and
           the three cluster barriers, no point read;
  stage    + the chunk staged in shared memory;
  passes   + both passes over it;
  full     + the float64 SVD on CTA 0's thread 0: the kernel.

For each design also ``nojacobi``, the full kernel without the Jacobi
sweeps (V = I), so that the sweeps' share of the SVD shows, and for the
cluster design ``nostage``, the full kernel reading device memory in both
passes.  Each ``--cluster`` source (another version of the cluster design,
with the same C interface) is split the same way beside ``csrc``'s.  It builds them
with ``cuda_build.NVCC_FLAGS`` (one ``nvcc`` each, at once), prints each
one's ``ptxas`` line (registers, stack frame, spills), then times every
variant in turns at the path's three shapes (the mid stage's 64 x 1024 and
the tracking scans' 1 x 16384 and 1 x 4096) on inputs made from a seed, 80%
inliers: the median over rounds of the mean device time of ``--reps``
back-to-back launches between CUDA events.  Each piece's time is the
difference between two neighbouring variants.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from open3d_slam_torch.ops import cuda_build
from open3d_slam_torch.utils import device as devmod

SHAPES = ((64, 1024), (1, 16384), (1, 4096))
SPLIT_DIR = os.path.join(cuda_build.BUILD_DIR, "split")

_NO_SVD = ("  kabsch_rotation(H, R);\n",
           "  for (int r = 0; r < 3; ++r)\n    for (int k = 0; k < 3; ++k) R[r][k] = H[r][k];\n")
_NO_JACOBI = ("  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {",
              "  for (int sweep = 0; sweep < 0; ++sweep) {")
_NO_STAGE = ("  if (staged) {\n", "  if (false) {\n")
_PASS1 = "for (int i = threadIdx.x; i < M; i += kThreads) {\n    if (!wb[i]) continue;\n    acc[0]"
_PASS2 = ("for (int i = threadIdx.x; i < M; i += kThreads) {\n    if (!wb[i]) continue;\n"
          "    float a[3], c[3];")
# Per design: its variants from the full kernel down, each the one before it
# with one more piece cut (a list of replacements).
DESIGNS: Dict[str, List[Tuple[str, List[Tuple[str, str]]]]] = {
    "one_block": [
        ("tree2", [_NO_SVD]),
        ("pass2", [("  tree_sum(s, 9);\n", "")]),
        ("tree1", [(_PASS2, _PASS2.replace("i < M;", "i < 0;"))]),
        ("pass1", [("  tree_sum(s, 7);\n", "")]),
        ("launch", [(_PASS1, _PASS1.replace("i < M;", "i < 0;"))]),
    ],
    "cluster": [
        ("passes", [_NO_SVD]),
        ("stage", [(f"  chunk_pass<{k}>(P, Q, W, n, bar, acc);\n",
                    f"  chunk_pass<{k}>(P, Q, W, 0, bar, acc);\n") for k in ("false", "true")]),
        ("launch", [_NO_STAGE]),
    ],
}
# Per design: variants of the full kernel with one piece cut alone.
ALONE = {"one_block": {"nojacobi": [_NO_JACOBI]},
         "cluster": {"nojacobi": [_NO_JACOBI], "nostage": [_NO_STAGE]}}


def variant_sources(design: str, text: str) -> Dict[str, str]:
    """The design's variants, from its full source ``text``, in order from
    the least to the full kernel, then those with one piece cut alone;
    raises if a cut does not find its text exactly once."""
    out = {"full": text}

    def cut(src, name, pairs):
        for old, new in pairs:
            if src.count(old) != 1:
                raise ValueError(f"p2p_split: a cut of {design}/{name} matches "
                                 f"{src.count(old)} times")
            src = src.replace(old, new)
        return src

    for name, pairs in DESIGNS[design]:
        text = out[name] = cut(text, name, pairs)
    ordered = dict(reversed(list(out.items())))
    for name, pairs in ALONE[design].items():
        ordered[name] = cut(ordered["full"], name, pairs)
    return ordered


def build(sources: Dict[str, str]) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """Compile every source (one ``nvcc`` each, started together) into
    ``SPLIT_DIR``; returns the loaded libraries and the ptxas lines."""
    nvcc = devmod.nvcc_path()
    if nvcc is None:
        raise RuntimeError("p2p_split: nvcc not found")
    os.makedirs(SPLIT_DIR, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(SPLIT_DIR, f"p2p_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(SPLIT_DIR, f"libp2p_{name}.so")
        procs[name] = (lib, subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"p2p_split: nvcc failed for {name}:\n{log}")
        logs[name] = cuda_build.ptxas_summary(log)
        libs[name] = ctypes.CDLL(lib)
    return libs, logs


def launcher(lib: ctypes.CDLL, cluster: bool = False) -> Callable:
    """A variant's entry as a function of (pts, q, w) -> dT: the one-block
    design's ``p2p_step_launch(pts, q, w, out, B, M, stream)``, or with
    ``cluster`` the current one's, which also takes the cluster size."""
    from open3d_slam_torch.ops import cuda_p2p
    fn = lib.p2p_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (3 if cluster else 2) + \
        [ctypes.c_void_p]

    def run(pts, q, w):
        b, m, _ = pts.shape
        out = torch.empty((b, 4, 4), dtype=torch.float32, device=pts.device)
        sizes = (b, m, cuda_p2p.cluster_size(m)) if cluster else (b, m)
        err = fn(pts.data_ptr(), q.data_ptr(), w.data_ptr(), out.data_ptr(), *sizes,
                 torch.cuda.current_stream(pts.device).cuda_stream)
        cuda_build.check(err, "p2p_split variant")
        return out
    return run


def inputs(rng, b: int, m: int, dev):
    """Rotated, shifted, noisy copies of anisotropic clouds 10 m out, 80%
    inliers (the card tests' Kabsch inputs)."""
    pts = rng.normal(size=(b, m, 3)) * np.array([4.0, 2.5, 1.0]) + rng.normal(
        scale=10.0, size=(b, 1, 3))
    ang = rng.uniform(-0.4, 0.4, size=b)
    c, s = np.cos(ang), np.sin(ang)
    R = np.zeros((b, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1.0
    q = np.einsum("bij,bmj->bmi", R, pts) + rng.normal(scale=0.03, size=(b, m, 3))
    w = rng.uniform(size=(b, m)) < 0.8
    return tuple(torch.from_numpy(a).to(dev) for a in (pts.astype(np.float32),
                                                       q.astype(np.float32), w))


def mean_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` launches between two CUDA
    events, queued behind a device-side sleep so that the host's Python
    between launches is not timed."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", required=True, help="the one-block design's p2p_step.cu")
    ap.add_argument("--cluster", action="append", default=[],
                    help="another source of the cluster design, split beside csrc's")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("p2p_split: needs a CUDA card", file=sys.stderr)
        return 1
    from open3d_slam_torch.ops import cuda_p2p
    dev = torch.device("cuda")
    print(f"card: {devmod.nvidia_smi_name_power()}", flush=True)
    texts = {"cluster": os.path.join(cuda_build.CSRC_DIR, "p2p_step.cu"),
             "one_block": args.source}
    for path in args.cluster:
        texts["cluster_" + os.path.splitext(os.path.basename(path))[0]] = path
    sources = {}
    for design, path in texts.items():
        with open(path) as f:
            cuts = "one_block" if design == "one_block" else "cluster"
            for name, text in variant_sources(cuts, f.read()).items():
                sources[f"{design}.{name}"] = text
    libs, logs = build(sources)
    for name in sources:
        print(f"ptxas[{name}]: {logs[name]}")
    runs = {name: launcher(libs[name], cluster=name.startswith("cluster"))
            for name in sources}
    rng = np.random.default_rng(0)
    for b, m in SHAPES:
        pts, q, w = inputs(rng, b, m, dev)
        plain = cuda_p2p.p2p_step_plain(pts, q, w)
        for design in texts:
            got = runs[f"{design}.full"](pts, q, w)
            print(f"{b}x{m} {design}: R against the plain version "
                  f"{float((got[:, :3, :3] - plain[:, :3, :3]).abs().max()):.3e}")
        times = {name: [] for name in runs}
        for _ in range(args.rounds):          # every variant in turns, every round
            for name, fn in runs.items():
                times[name].append(mean_ms(lambda: fn(pts, q, w), args.reps))
        ms = {name: statistics.median(t) for name, t in times.items()}
        for design in texts:
            alone = ALONE["one_block" if design == "one_block" else "cluster"]
            order = [n for n in sources if n.startswith(design + ".") and
                     n.split(".")[1] not in alone]
            pieces = [f"{order[0].split('.')[1]} {ms[order[0]] * 1e3:.2f}"] + [
                f"{later.split('.')[1]} {(ms[later] - ms[earlier]) * 1e3:.2f}"
                for earlier, later in zip(order, order[1:])]
            full = ms[f"{design}.full"]
            print(f"{b}x{m} {design}: {full * 1e3:.2f} us = " + " + ".join(pieces) + "; "
                  + ", ".join(f"without {n[2:]} {ms[f'{design}.{n}'] * 1e3:.2f} us"
                              for n in alone), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
