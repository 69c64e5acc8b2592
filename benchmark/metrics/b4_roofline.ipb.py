"""b4_roofline.ipb (%): the quadratic-tier kernel B4's share of its roofline
in a ``quadratic_fused`` cell on the inducing-point basis.

A step's least time is the larger of its products' useful operations at the
dense TF32 peak (495 TFLOP/s) and its compulsory bytes at 3.35 TB/s. The
operations are A U, E U' and S eps, 6 M^2 J; the Philox normals, the update
and the energy terms are left out of the bound, so that no correct rewrite
of the kernel reads over 100%. The bytes are fp32: U read once and written
once (A, E and S, 3 MB, stay in L2 across the steps and are not counted).
The measured time is B4's device time (``quadratic_run_kernel``, one
cooperative launch a call) over the window's steps (its particle updates
over J): from the profiler where it recorded B4 once in every call, else
from B4's own ``%globaltimer`` record of each call (``b4_ms`` of the cell's
shapes). Which source it took goes to standard error."""

import re
import sys

from benchmark.harness.peaks import TF32_OPS_PER_S, bound_s, share_pct

KERNEL = re.compile(r"\bquadratic_run_kernel\b")


def step_operations(shapes) -> float:
    return 6.0 * shapes["m_k"] ** 2 * shapes["j"]


def step_bytes(shapes) -> float:
    return 4.0 * 2 * shapes["m_k"] * shapes["j"]


def _b4_ops(trace, call):
    return [o for o in trace.ops_in(call.start_ns, call.end_ns)
            if o.kind == "kernel" and KERNEL.search(o.name)]


def recorded_every_call(trace) -> bool:
    """The profiler shows one B4 run in each call of the window."""
    return bool(trace.calls) and all(len(_b4_ops(trace, c)) == 1 for c in trace.calls)


def record_s(trace, shapes) -> float | None:
    """B4's device seconds over the window's calls from its own record; None
    where the record does not cover every call."""
    ms = shapes.get("b4_ms") or []
    if len(ms) != len(trace.calls) or any(v is None for v in ms):
        return None
    return sum(ms) / 1e3


def device_s(trace, shapes) -> tuple[float | None, str]:
    """B4's device seconds in the window, and their source."""
    if recorded_every_call(trace):
        return trace.device_s([o for c in trace.calls for o in _b4_ops(trace, c)]), "trace"
    return record_s(trace, shapes), "record"


def read(trace, shapes):
    seconds, source = device_s(trace, shapes)
    seen = sum(1 for c in trace.calls if _b4_ops(trace, c))
    print(f"b4_roofline.ipb: the profiler recorded B4 in {seen} of {len(trace.calls)} calls; "
          f"source {source}", file=sys.stderr)
    steps = trace.work / shapes["j"]
    if not seconds or steps <= 0:
        return None
    least = bound_s(step_operations(shapes), step_bytes(shapes), TF32_OPS_PER_S)
    return share_pct(least, seconds / steps)
