"""updates_mfu (%): the whole Langevin step's share of the fp64 peak.

The work the inputs need for one particle update on the ONB basis is its
two products with the train projection, F = P U and P^T dc(F): 4 N M_k
operations; the cost's quadrature and the elementwise update are not
counted. The time is the device's busy time inside the calls' spans. fp64
work counts against 67 TFLOP/s (FP64 on the tensor cores)."""

from benchmark.harness.peaks import FP64_TENSOR_OPS_PER_S
from benchmark.harness.readers import call_busy_s


def read(trace, shapes):
    busy = call_busy_s(trace)
    if busy <= 0.0 or trace.work <= 0.0:
        return None
    ops = 4.0 * shapes["n"] * shapes["m_k"] * trace.work
    return 100.0 * ops / (busy * FP64_TENSOR_OPS_PER_S)
