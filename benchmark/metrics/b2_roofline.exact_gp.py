"""b2_roofline.exact_gp (%): the gram kernel B2's share of its roofline
in a ``fit_exact_gp`` cell.

One launch computes the same-input fp64 gram of n rows of D inputs: it
reads n D values and writes n^2, each byte once, and does about 3 D + 2
operations an entry; the least time is the larger of the bytes at 3.35 TB/s
and the operations at 67 TFLOP/s. The measured time is the mean device time
of the kernels whose names hold ``ard_gram`` inside the calls' spans. B2's
backward runs as plain PyTorch operations and is not in this share."""

from benchmark.harness.peaks import FP64_TENSOR_OPS_PER_S, bound_s, share_pct


def read(trace, shapes):
    ops = [o for o in trace.call_ops() if "ard_gram" in o.name]
    if not ops:
        return None
    n, d = shapes["n"], shapes["d"]
    least = bound_s((3.0 * d + 2.0) * n * n, 8.0 * (n * d + n * n), FP64_TENSOR_OPS_PER_S)
    return share_pct(least, trace.device_s(ops) / len(ops))
