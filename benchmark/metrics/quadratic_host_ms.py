"""quadratic_host_ms (ms): the milliseconds a ``quadratic_fused`` call holds
the device idle while ``train_pls`` makes the M-space system (the span
``pls.train_pls.quadratic_system``: A, b, E and the energy's bias and
constant) and B4's wrapper prepares its run (the casts, the phase plan, the
buffers: ``pls.quadratic_train.prepare``) and replays the stopper over the
energies (``pls.quadratic_train.stopper``), averaged over the window's
calls. None where the trace holds none of these spans."""

from benchmark.harness.spans import idle_by_span

NAMES = ("pls.train_pls.quadratic_system", "pls.quadratic_train.prepare",
         "pls.quadratic_train.stopper")


def read(trace, shapes):
    if not any(o.name in NAMES for o in trace.host):
        return None
    booked = idle_by_span(trace)
    return sum(booked.get(n, 0) for n in NAMES) / len(trace.calls) / 1e6
