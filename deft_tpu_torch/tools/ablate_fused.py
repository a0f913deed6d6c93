"""Where T3's time goes on the card: ``dcn_fused.cu`` built whole and with
its phases taken out, timed at the 7 DLA-34 DCNv2 layer shapes.

    python3 -m deft_tpu_torch.tools.ablate_fused [--source FILE ...]
        [--per-sm N ...] [--variants full,...]

Each variant is a copy of the source with the bodies of some of its phases
emptied (an ``#ifdef`` return at the top of the phase's lambda):

* ``full``: the kernel as it is, checked against the plain version;
* ``no_mma``: every chunk's MMAs are skipped (``mma_chunk``); the gathers,
  blends, weight copies and barriers stay;
* ``no_sample``: every chunk's corner gathers and blends are skipped
  (``gather``, ``blend_store``); the weight tiles still stream in;
* ``overhead``: both, leaving phase 1's corner table, the weight copies,
  the barriers, the epilogue and the split-K reduction.

Only ``full`` computes the function.  If the phases overlapped perfectly,
``full`` would take the longer of ``no_sample`` and ``no_mma``; if they ran
one after the other, about their sum less ``overhead``.  ``--source`` takes
other versions of ``dcn_fused.cu`` with the same C entry and lambdas (a
parent commit's, unpacked with ``git archive``) to time beside this one in
one run.  ``--per-sm N`` also times this source with the split planned
for N blocks per SM instead of ``cuda_dcn.FUSED_PER_SM``.  Every build goes into ``build/ablate/``, one ``nvcc``
each, all at once.  Times are device ms per call: 20 calls captured in a CUDA
graph, replayed 7 times, median.  Prints one JSON line per source and
variant with per-layer times and the per-frame sum over the 16 layers, and
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deft_tpu_torch.csrc import build
from deft_tpu_torch.ops import cuda_dcn

RADIUS = 4
SEED = 0
# (H, W, C, Cout, layers per frame) at 544x960, as chip_smoke.py's LAYERS
LAYERS = [(136, 240, 64, 64, 5), (68, 120, 128, 64, 4), (68, 120, 128, 128, 2),
          (34, 60, 256, 128, 2), (34, 60, 256, 256, 1), (34, 60, 256, 64, 1),
          (17, 30, 512, 256, 1)]
# phase lambda of dcn_fused.cu -> the macro that empties it
PHASES = {"gather": "ABLATE_NO_SAMPLE", "blend_store": "ABLATE_NO_SAMPLE",
          "mma_chunk": "ABLATE_NO_MMA"}
VARIANTS = {"full": (), "no_mma": ("ABLATE_NO_MMA",),
            "no_sample": ("ABLATE_NO_SAMPLE",),
            "overhead": ("ABLATE_NO_MMA", "ABLATE_NO_SAMPLE")}
BUILD_DIR = build.BUILD_DIR.parent / "ablate"


def ablatable(source: str, phases: dict = PHASES) -> str:
    """``source`` with an ``#ifdef <macro> return; #endif`` at the top of
    each phase lambda of ``phases`` (name -> macro); raises unless each
    lambda appears exactly once."""
    for name, macro in phases.items():
        pattern = re.compile(r"\n( *)auto " + name + r" = \[&\]\([^{]*\) \{\n")
        hits = list(pattern.finditer(source))
        if len(hits) != 1:
            raise ValueError(f"lambda {name!r} found {len(hits)} times")
        at = hits[0].end()
        indent = hits[0].group(1) + "  "
        source = (source[:at] + f"#ifdef {macro}\n{indent}return;\n#endif\n"
                  + source[at:])
    return source


def build_all(sources: dict, variants, phases: dict = PHASES,
              macros: dict = VARIANTS) -> dict:
    """Compile the ``variants`` (name -> macros defined, ``macros``) of each
    {tag: source}, its ``phases`` made ablatable, the source's own
    directory on the include path, one nvcc each, all at once; return
    (tag, variant) -> library path."""
    builds = []
    for tag, source in sources.items():
        out_dir = BUILD_DIR / tag
        out_dir.mkdir(parents=True, exist_ok=True)
        patched = out_dir / f"{source.stem}_ablate.cu"
        patched.write_text(ablatable(source.read_text(), phases))
        flags = list(build.NVCC_FLAGS)
        flags[flags.index("-I") + 1] = str(source.parent)
        builds += [(tag, variant, patched, flags) for variant in variants]

    def one(job):
        tag, variant, patched, flags = job
        lib = patched.with_name(f"lib{patched.stem}_{variant}.so")
        cmd = [build._nvcc(), *flags,
               *(f"-D{m}" for m in macros[variant]), "-o", str(lib),
               str(patched)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {variant}:\n"
                               f"{proc.stdout}{proc.stderr}")
        return (tag, variant), lib

    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        return dict(pool.map(one, builds))


def entry(lib_path: Path):
    fn = ctypes.CDLL(str(lib_path)).dcn_fused
    fn.argtypes = cuda_dcn._SIGNATURES["dcn_fused"]["dcn_fused"]
    fn.restype = ctypes.c_int
    return fn


def layer_inputs(rng, h, w, c, cout, dev):
    """x, 'trained' offsets (N(0, 0.5) clipped to +-2 px), mask, weight,
    bias, as chip_smoke.py makes them."""
    x = torch.from_numpy(rng.normal(0, 1, (h, w, c)).astype(np.float32)).to(dev)
    offsets = torch.from_numpy(np.clip(rng.normal(0, 0.5, (h, w, 9, 2)),
                                       -2, 2).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(0, 1, (h, w, 9)).astype(np.float32)
                            ).to(dev)
    weight = torch.from_numpy((rng.normal(0, 1, (9 * c, cout))
                               / math.sqrt(9 * c)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)
                            ).to(dev)
    return x, offsets, mask, weight, bias


def launcher(fn, x, offsets, mask, weight, bias, per_sm=None):
    """A closure that runs one float32 call of ``fn`` as
    ``cuda_dcn.deform_conv_fused`` does, into buffers allocated once;
    ``per_sm`` plans the split for that many blocks per SM."""
    h, w, c = x.shape
    cout = weight.shape[1]
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if per_sm is not None:
        sms = sms * per_sm // cuda_dcn.FUSED_PER_SM
    plan = cuda_dcn.plan_fused(h, w, c, cout, sms)
    out = torch.empty((h, w, cout), dtype=torch.float32, device=dev)
    ws = torch.empty(max(plan.workspace, 1), dtype=torch.float32, device=dev)
    xb = x.to(torch.bfloat16)

    def run():
        err = fn(xb.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
                 weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if plan.workspace else None, h, w, c, cout,
                 RADIUS, 0, plan.bn, plan.splits, plan.chunks_per_split,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"dcn_fused launch failed: CUDA error {err}")
        return out

    return run


def graph_ms(fn, per_graph: int = 20, reps: int = 7) -> float:
    """Median device ms of one ``fn()``: ``per_graph`` calls in a CUDA
    graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", action="append", type=Path, default=[],
                        help="another dcn_fused.cu to time beside this one")
    parser.add_argument("--per-sm", action="append", type=int, default=[],
                        help="also time this source planned for N blocks "
                             "per SM")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated subset of "
                             + ", ".join(VARIANTS))
    args = parser.parse_args()
    variants = args.variants.split(",")
    if not set(variants) <= set(VARIANTS):
        parser.error(f"--variants: not in {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("ablate_fused: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    sources = {"this": build.CSRC / "dcn_fused.cu"}
    sources.update({f"source{i}": p.resolve()
                    for i, p in enumerate(args.source)})
    libs = build_all(sources, variants)
    # (tag, blocks per SM of the plan; None: FUSED_PER_SM)
    runs = [(tag, None) for tag in sources]
    runs += [("this", n) for n in args.per_sm]
    rng = np.random.RandomState(SEED)
    inputs = [layer_inputs(rng, h, w, c, cout, dev)
              for h, w, c, cout, _ in LAYERS]
    for tag, per_sm in runs:
        for variant in variants:
            fn = entry(libs[tag, variant])
            per_layer = []
            for (h, w, c, cout, count), args_ in zip(LAYERS, inputs):
                run = launcher(fn, *args_, per_sm=per_sm)
                if variant == "full":
                    got = run().clone()
                    ref = cuda_dcn.deform_conv_fused_reference(*args_, RADIUS)
                    err = (got - ref).abs().max().item()
                    if not err <= 1e-4 * ref.abs().max().item():
                        raise AssertionError(f"{tag} full disagrees with the "
                                             f"plain version at "
                                             f"{(h, w, c, cout)}: {err}")
                per_layer.append({"shape": [h, w, c, cout], "count": count,
                                  "ms": graph_ms(run)})
            print(json.dumps({
                "source": str(sources[tag]),
                "per_sm": per_sm or cuda_dcn.FUSED_PER_SM,
                "variant": variant,
                "ms_per_frame": sum(r["ms"] * r["count"] for r in per_layer),
                "layers": per_layer}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
