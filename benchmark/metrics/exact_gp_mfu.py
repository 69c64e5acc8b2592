"""exact_gp_mfu (%): the exact-GP epoch's share of the fp64 peak.

The work the inputs need for one epoch of the loss and its gradient on n
rows of D inputs: the factor of K + noise I (n^3 / 3), the inverse from it
that the gradient needs (2 n^3 / 3), the two triangular solves (2 n^2), the
gram (3 n^2 D + n^2) and its gradient (4 n^2 D). The time is the device's
busy time inside the calls' spans; fp64 counts against 67 TFLOP/s."""

from benchmark.harness.peaks import FP64_TENSOR_OPS_PER_S
from benchmark.harness.readers import call_busy_s


def epoch_ops(n: int, d: int) -> float:
    return n**3 / 3.0 + 2.0 * n**3 / 3.0 + 2.0 * n**2 + (3.0 * d + 1.0) * n**2 + 4.0 * d * n**2


def read(trace, shapes):
    busy = call_busy_s(trace)
    if busy <= 0.0 or trace.work <= 0.0:
        return None
    return 100.0 * epoch_ops(shapes["n"], shapes["d"]) * trace.work / (busy * FP64_TENSOR_OPS_PER_S)
