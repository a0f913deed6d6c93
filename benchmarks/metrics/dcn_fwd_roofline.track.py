"""The DCNv2 sampling kernels' share of their roofline in the traced
stretch, in percent: the least time of their launches (``benchmarks/
counts.py::sample_bound_s`` per layer shape, bf16 or float32 x and patches
as the compute dtype) over the device time of the kernels ``dcn_sample``
(T1) and ``dcn_onehot`` (T4) in the trace.  A frame launches one of them
per DCNv2 layer; the launch counters say how many frames the stretch
held."""

from benchmarks.counts import sample_bound_s

KERNELS = ("dcn_sample_kernel", "dcn_onehot_kernel")


def read(run):
    if not run.trace:
        return None
    t = sum(v for k, v in run.trace["kernels"].items()
            if any(name in k for name in KERNELS))
    n = run.launches["t1"] + run.launches["t4"]
    if t <= 0 or n <= 0:
        return None
    nbytes = 2 if run.dtype == "bfloat16" else 4
    per_frame = sum(sample_bound_s(h, w, c, nbytes, nbytes)
                    for h, w, c, _ in run.dcn_layers)
    return 100.0 * per_frame * n / len(run.dcn_layers) / t
