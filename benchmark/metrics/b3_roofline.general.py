"""b3_roofline.general (%): the general-cost kernel B3's share of its
roofline in a ``general_fused`` cell.

A step's least time is the larger of its products' useful operations at the
dense TF32 peak (495 TFLOP/s) and its compulsory bytes at 3.35 TB/s. The
operations are F = P U and P^T dc, 4 N M_k J; the GH16 quadrature's special
functions are left out of the bound, so that no correct rewrite of the kernel
reads over 100%. The bytes are fp32: P, U, y and the smoothing std read once,
U written once (dc stays on the card between the two products and is not
compulsory). The measured time is the device time of B3's kernels (the
forward product with the cost epilogue, the transposed product with the
update, the one-block stopper) inside the calls' spans, over the window's
steps (its particle updates over J)."""

import re

from benchmark.harness.peaks import TF32_OPS_PER_S, bound_s, share_pct

KERNEL = re.compile(r"\b(forward|update|stop)_kernel\b")


def step_operations(shapes) -> float:
    return 4.0 * shapes["n"] * shapes["m_k"] * shapes["j"]


def step_bytes(shapes) -> float:
    n, m_k, j = shapes["n"], shapes["m_k"], shapes["j"]
    return 4.0 * (n * m_k + 2 * m_k * j + 2 * n)


def read(trace, shapes):
    ops = [o for o in trace.call_ops() if o.kind == "kernel" and KERNEL.search(o.name)]
    steps = trace.work / shapes["j"]
    if not ops or steps <= 0:
        return None
    least = bound_s(step_operations(shapes), step_bytes(shapes), TF32_OPS_PER_S)
    return share_pct(least, trace.device_s(ops) / steps)
