"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmarks.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic; the traffic's ``kind`` names the driver
(``benchmarks/cells/<kind>.py``) that sets the cell up, measures for
``--seconds`` and judges what the timed path produced against the plain
reference (``benchmarks/reference/``).  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
read by ``benchmarks/metrics/<name>.py``), ``device``, ``breakdown`` (with
``--trace 1``) and last ``checks``: each number the comparison took, with
its limit (``benchmarks/limits/<cell>.json``); the same pairs are the last
lines of standard error.

The run exits non-zero and prints no result where the cell's CUDA devices
are missing, and where, once the window has closed, the process holds a
module of JAX, of the JAX package or of the JAX repository's root scripts.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one thread per process for the host's numerical libraries: the program's
# host work is small arrays on its own threads, and a pool per library on
# a shared machine makes the runs' times spread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

from benchmarks.spec import Spec  # noqa: E402

# modules the run may not hold, by top-level name: JAX's, and the JAX
# package's; the JAX repository's root scripts count where they are this
# checkout's files (``test`` is also the standard library's package)
FORBIDDEN = ("jax", "jaxlib", "flax", "deft_tpu")
ROOT_SCRIPTS = ("bench", "train", "test", "train_prediction", "tools",
                "chip_smoke")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env(root: Path):
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def forbidden_modules(root: Path) -> List[str]:
    found = set()
    for name, module in list(sys.modules.items()):
        top = name.split(".")[0]
        if top in FORBIDDEN:
            found.add(top)
        elif top in ROOT_SCRIPTS:
            path = getattr(module, "__file__", None)
            if path and Path(path).resolve().is_relative_to(root.resolve()):
                found.add(top)
    return sorted(found)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, device=None, overrides: Optional[dict] = None,
         fault: Optional[Callable] = None) -> int:
    """Run the cell; 0 with the result line printed, else non-zero.
    ``device``, ``overrides`` (merged into the configuration and the
    traffic) and ``fault`` (applied to the program after set-up) are for
    the benchmark's own tests, which run a cell on the CPU at a tiny
    size; a run from the command line takes none of them."""
    args = parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for key, value in (overrides or {}).get("config", {}).items():
        config[key] = value
    for key, value in (overrides or {}).get("traffic", {}).items():
        traffic[key] = value
    import torch

    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell["chips"]:
            log(f"error: {cell['name']} needs {cell['chips']} CUDA "
                f"device(s); torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, {n} found")
            return 2
        device = torch.device("cuda")
    ctx = SimpleNamespace(args=args, root=root, cell=cell, config=config,
                          traffic=traffic, limits=spec.limits(cell["name"]),
                          device=device, t_start=T_START, fault=fault,
                          log=log)
    out = spec.driver(traffic["kind"]).run(ctx)

    bad = forbidden_modules(root)
    if bad:
        log("error: the run holds modules it may not: " + ", ".join(bad))
        return 3
    metrics = {}
    for m in spec.metrics(cell, bool(args.trace)):
        if args.trace:
            value = spec.reader(m["name"])(out["layer"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": ctx.limits[k]}
              for k, v in out["checks"].items()}
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
