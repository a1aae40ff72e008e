"""How a run starts and ends: no card, no program, no JAX."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import core

RUN = os.path.join(core.HERE, "run.py")
ARGS = ["--workload", "vlp16_mapping.revisit_loops", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, os.path.join(cwd, "perfbench", "run.py"), *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(core.ROOT, env)
    assert p.returncode != 0
    assert "CUDA" in p.stderr
    assert not p.stdout.strip()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_fails_in_a_directory_of_the_benchmark_alone(card, tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "out"))
    p = _run(str(tmp_path))
    assert p.returncode != 0
    assert not p.stdout.strip()


def _modules_after(code: str) -> dict:
    prog = (f"import sys, json; sys.path.insert(0, {core.ROOT!r}); {code}; "
            "print(json.dumps(sorted(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       timeout=300, cwd=core.ROOT)
    assert p.returncode == 0, p.stderr
    return {m.split(".", 1)[0] for m in json.loads(p.stdout.strip().splitlines()[-1])}


def test_the_harness_loads_no_jax():
    top = _modules_after("import perfbench.run, perfbench.core, perfbench.runners.mapping, "
                         "perfbench.generators.lidar, perfbench.reference.poses, "
                         "perfbench.reference.pose_graph")
    assert not top & set(core.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    top = _modules_after("import perfbench.reference.poses, perfbench.reference.pose_graph, "
                         "perfbench.generators.lidar")
    assert "open3d_slam_torch" not in top
    assert not top & set(core.FORBIDDEN_MODULES)


def test_a_run_through_the_port_loads_no_jax():
    """A mapping run on the CPU, through the program, leaves neither JAX nor
    the JAX package in ``sys.modules``."""
    top = _modules_after(
        "sys.path.insert(0, 'perfbench/tests'); import cpu_cells; "
        "out = cpu_cells.run(cpu_cells.MAPPING, 3, 2.0); assert out['attempted'] >= 1")
    assert "open3d_slam_torch" in top
    assert not top & set(core.FORBIDDEN_MODULES)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "open3d_slam_tpu_extra.x", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "open3d_slam_tpu.ops", sys)
    assert core.forbidden_modules() == ["open3d_slam_tpu.ops"]
