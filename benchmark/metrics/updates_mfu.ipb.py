"""updates_mfu.ipb (%): the whole Langevin step's share of the TF32 peak in a
``quadratic_fused`` cell on the inducing-point basis.

The work the inputs need for one step of the M-space system is its three
products, A U, E U' and S eps: 6 M^2 J operations (the Philox normals, the
update and the energy terms on the CUDA cores are not counted). The time is
the device's busy time inside the calls' spans. Where the profiler recorded
no B4 run in some call (ROADMAP: it has at times recorded none for the
cooperative kernel), that busy time leaves B4 out, and B4's own device time
from its ``%globaltimer`` record (``b4_ms`` of the cell's shapes) stands in
for it. The work counts against the dense TF32 peak (495 TFLOP/s): the
program keeps fp32 accuracy with three TF32 products each, so no
fp32-accurate implementation reads over 100%."""

import importlib.util
import os

from benchmark.harness.peaks import TF32_OPS_PER_S
from benchmark.harness.readers import call_busy_s


def _b4():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "b4_roofline.ipb.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_b4_roofline_ipb", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(trace, shapes):
    b4 = _b4()
    if b4.recorded_every_call(trace):
        busy = call_busy_s(trace)
    else:
        record_s = b4.record_s(trace, shapes)
        if record_s is None:
            return None
        others = [o for o in trace.call_ops() if not b4.KERNEL.search(o.name)]
        busy = sum(trace.busy_ns([o for o in others if c.start_ns <= o.start_ns < c.end_ns],
                                 c.start_ns, c.end_ns) for c in trace.calls) / 1e9 + record_s
    if busy <= 0.0 or trace.work <= 0.0:
        return None
    ops = 6.0 * shapes["m_k"] ** 2 * trace.work
    return 100.0 * ops / (busy * TF32_OPS_PER_S)
