"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the full 700 W) and the roofline arithmetic the per-layer metrics use.

A frozen copy of ``chip_smoke.py``'s ``tc_bound`` and its peaks, with the
fp64 peak added. A share is stated against these peaks whatever the card's
power limit; the result line carries the limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_OPS_PER_S = 67e12  # FP64 on the tensor cores
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12


def tc_bound(products_flops, elementwise_ops, nbytes):
    """The least time in ms of work whose fp32 products run as three TF32
    products on the tensor cores: the larger of those at 495 TFLOP/s, the
    elementwise operations at 67 TFLOP/s on the CUDA cores, and the bytes at
    3.35 TB/s; with the name of the larger term."""
    terms = {"tf32 products": 1e3 * 3 * products_flops / TF32_OPS_PER_S,
             "fp32 elementwise": 1e3 * elementwise_ops / FP32_OPS_PER_S,
             "bytes": 1e3 * nbytes / HBM_BYTES_PER_S}
    term = max(terms, key=terms.get)
    return terms[term], term


def bound_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least seconds of work of ``ops`` operations at ``ops_per_s`` that
    reads and writes ``nbytes`` at the HBM rate."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def share_pct(least_s: float, measured_s: float | None) -> float | None:
    """100 least / measured; None where nothing was measured (never 0)."""
    if not measured_s or measured_s <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / measured_s
