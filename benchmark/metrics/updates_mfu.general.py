"""updates_mfu.general (%): the whole Langevin step's share of the TF32 peak
in a ``general_fused`` cell.

The work the inputs need for one particle update on the ONB basis is its two
products with the train projection, F = P U and P^T dc: 4 N M_k operations;
the cost's quadrature and the elementwise update are not counted. The time is
the device's busy time inside the calls' spans. The work counts against the
dense TF32 peak (495 TFLOP/s), the fastest rate at which the card multiplies
fp32 operands at all: the program keeps fp32 accuracy with three TF32
products each, so no fp32-accurate implementation reads over 100%."""

from benchmark.harness.peaks import TF32_OPS_PER_S
from benchmark.harness.readers import call_busy_s


def read(trace, shapes):
    busy = call_busy_s(trace)
    if busy <= 0.0 or trace.work <= 0.0:
        return None
    ops = 4.0 * shapes["n"] * shapes["m_k"] * trace.work
    return 100.0 * ops / (busy * TF32_OPS_PER_S)
