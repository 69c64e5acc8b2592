"""What several per-layer metrics read from a traced window: the device's
busy time inside the calls, the kernels inside them, the idle share. Each
metric's own file under ``metrics/`` says what it divides by what."""

from __future__ import annotations

from benchmark.harness.timing import Trace


def call_busy_s(trace: Trace) -> float:
    """Seconds in which some device operation ran inside a call's span."""
    return sum(trace.busy_ns(trace.ops_in(c.start_ns, c.end_ns), c.start_ns, c.end_ns)
               for c in trace.calls) / 1e9


def call_kernels(trace: Trace) -> int:
    """Kernels that started inside the calls' spans."""
    return sum(1 for o in trace.call_ops() if o.kind == "kernel")


def idle_pct(trace: Trace, shapes: dict) -> float | None:
    """100 (1 - busy / window): the share of the window in which no
    operation ran on the device."""
    if trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def host_ms_per_call(trace: Trace) -> float | None:
    """Mean milliseconds a call holds the device idle inside its span."""
    if not trace.calls:
        return None
    idle = [(c.end_ns - c.start_ns) - trace.busy_ns(trace.ops_in(c.start_ns, c.end_ns),
                                                    c.start_ns, c.end_ns) for c in trace.calls]
    return sum(idle) / len(idle) / 1e6
