"""One training forward and backward of the MOT model on the card, timed in
one or more checkouts of the repository, each in a process of its own, so
that two versions compare within one call:

    python3 -m deft_tpu_torch.tools.ab_train_step build/parent . . build/parent

Each argument is the root of a checkout (``git archive`` of a commit
unpacked under ``build/``, or ``.``).  Its process builds that checkout's
kernels, makes ``mot_config(compute_dtype="bfloat16")``'s seeded model in
train mode and runs ``DEFTNet.train_forward`` on a seeded random batch of
4 images and 4 pre-images at 544x960 (all 100 centres valid), then the
backward of the mean square of every head and of the affinity: every
train-mode BatchNorm, both DCNv2 directions (T4, T5) and the AFE, without
the loader, the losses or the optimizer.  Prints one JSON line per
checkout: the median wall ms of 10 steps (each between CUDA events, after
3 warm-up steps), the device kernel ms per step over 3 more under
``torch.profiler``, the peak device memory; then the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

CHILD = r'''
import json, statistics, sys
sys.path.insert(0, ROOT)
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from deft_tpu_torch.config import mot_config
from deft_tpu_torch.csrc.build import build_all
from deft_tpu_torch.models.factory import create_model

build_all()
cfg = mot_config(compute_dtype="bfloat16")
model = create_model(cfg.arch, cfg, "cuda").train()
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(4, 544, 960, 3, device="cuda", generator=g)
pre = torch.randn(4, 544, 960, 3, device="cuda", generator=g)
c = torch.rand(4, 100, 2, device="cuda", generator=g) * 2 - 1


def step():
    out, aff = model.train_forward(x, pre, c, c)
    loss = (sum(o.float().square().mean() for o in out.values())
            + aff.float().square().mean())
    loss.backward()


for _ in range(3):
    step()
torch.cuda.synchronize()
times = []
for _ in range(10):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    step()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
        step()
    torch.cuda.synchronize()
device = 0.0
for evt in prof.key_averages():
    if evt.device_type == DeviceType.CUDA:
        t = getattr(evt, "self_device_time_total", None)
        device += evt.self_cuda_time_total if t is None else t
print(json.dumps({"root": ROOT, "wall_ms_median": statistics.median(times),
                  "device_ms": device / 1e3 / 3,
                  "peak_bytes": torch.cuda.max_memory_allocated()}))
'''


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ab_train_step")
    p.add_argument("roots", nargs="+", help="checkout roots, in run order")
    args = p.parse_args(argv)
    for root in args.roots:
        out = subprocess.run([sys.executable, "-c",
                              f"ROOT = {root!r}\n" + CHILD],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
