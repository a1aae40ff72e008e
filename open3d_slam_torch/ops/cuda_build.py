"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``.  Libraries go to ``_build/`` inside
the package (listed in ``.gitignore``), named by a hash of the source, the
``csrc`` headers it includes and the flags, and are built at first use:
nothing is built when a module is imported, and nothing comes from outside
the checkout.  ``build_all`` starts
one ``nvcc`` per source at once, so a cold start costs the slowest build, not
the sum.

``launches`` counts every kernel launch by (kernel, input shape): each
wrapper adds one where it launches its kernel and nowhere else.  The counter
lives here, not on the wrapper functions, so wrapping or replacing a wrapper
neither hides nor forks it.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import subprocess
from typing import Dict, List, Optional, Tuple

from open3d_slam_torch.utils.device import nvcc_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("gicp", "normals", "knn", "icp")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}
launches: collections.Counter = collections.Counter()


def count_launch(kernel: str, shape: Tuple[int, ...]):
    launches[(kernel, tuple(shape))] += 1


def launch_total(kernel: str, counts: Optional[Dict] = None) -> int:
    """Launches of ``kernel`` over all shapes, in ``counts`` (a copy of
    ``launches`` taken earlier) or in ``launches`` itself."""
    return sum(n for (k, _), n in (launches if counts is None else counts).items()
               if k == kernel)


def _sources(path: str, seen: List[str]) -> List[str]:
    """``path`` and every ``csrc`` header it includes with quotes, in the
    order first included."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read().decode()
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
        _sources(os.path.join(os.path.dirname(path), inc), seen)
    return seen


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers it
    includes and the flags: editing any of them builds anew."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(os.path.join(CSRC_DIR, name + ".cu"), []):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.target = (tmp, out)
    return proc


def _finish_build(name: str, proc: subprocess.Popen):
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp, out = proc.target
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> Dict[str, str]:
    """Build every listed kernel library, one ``nvcc`` each, concurrently.
    Returns the nvcc logs (register and shared-memory use per kernel)."""
    procs = {n: _start_build(n) for n in names}
    errors = []
    for n, p in procs.items():
        if p is None:
            continue
        try:
            _finish_build(n, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return dict(build_logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        proc = _start_build(name)
        if proc is not None:
            _finish_build(name, proc)
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    return lib


def check(err: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")
