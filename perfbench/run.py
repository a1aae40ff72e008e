"""Runs one cell of the port's benchmark once, on the card it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its checks are found by name (``BENCHMARK.json``, ``perfbench/configs``,
``perfbench/traffic``, ``perfbench/checks``); a per-layer metric is read by
``perfbench/metrics/<name>.py``.  The last line of standard output is the
result as one JSON object; the numbers that decided ``correct`` are the last
lines of standard error and the result's last key.

Exits with 2, printing no result, without a CUDA card, with fewer cards than
the cell asks for, or outside a checkout that holds the program; with 3 when
JAX or the JAX package was loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# One process with few threads: the program's host work is single-threaded
# Python and small numpy and torch operations, and spinning thread pools on
# a machine whose cores are shared only spread the host's timings.
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
# Kernel and compiler caches at fixed paths inside the checkout: only the
# first run of a checkout builds.  (The program builds its own kernels into
# open3d_slam_torch/_build/, inside the checkout too.)
CACHES = {"TRITON_CACHE_DIR": os.path.join(HERE, ".cache", "triton"),
          "TORCH_EXTENSIONS_DIR": os.path.join(HERE, ".cache", "torch_extensions")}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(bench: dict, workload: str, out: dict, trace: bool, device: dict) -> dict:
    from perfbench import core
    metrics = {}
    for m in core.metrics_of(bench, workload, trace):
        if trace:
            value = core.metric_reader(m["name"])(out["trace"])
        elif m["name"] == "setup_s":
            value = out["setup_s"]
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {c["name"]: {"value": c["value"], "limit": core.limit_text(c)}
              for c in out["checks"]}
    line = {"correct": all(core.passes(c["value"], c["op"], c["limit"]) for c in out["checks"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace:
        prof = out["trace"]["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in {**CACHES, **THREADS}.items():
        os.environ[k] = v
    sys.path.insert(0, ROOT)
    try:
        from perfbench import core
        bench = core.benchmark()
        files = core.cell_files(bench, args.workload)
    except (ImportError, OSError, KeyError) as e:
        print(f"perfbench: cannot find the cell's files: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    chips = int(files["cell"]["chips"])
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is false: this benchmark needs a CUDA "
              "card and never falls back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import open3d_slam_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    out = core.runner(files["config"]).run(files, args.seed, args.seconds, bool(args.trace),
                                           "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: nothing it runs may load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(bench, args.workload, out, bool(args.trace), device)
    for msg in out["info"]:
        print(msg, file=sys.stderr)
    for c in out["checks"]:
        ok = core.passes(c["value"], c["op"], c["limit"])
        print(f"check {c['name']} = {c['value']!r} (limit {core.limit_text(c)}) "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
