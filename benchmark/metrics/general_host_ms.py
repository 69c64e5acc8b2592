"""general_host_ms (ms): the milliseconds a ``general_fused`` call holds the
device idle while the general-cost kernel's wrapper prepares its run (the
casts, the row constants, the GH16 scalars and the buffers) and replays the
stopper over the energies it reads back (the spans
``pls.general_train.prepare`` and ``pls.general_train.stopper``), averaged
over the window's calls. None where the trace holds neither span."""

from benchmark.harness.spans import idle_by_span

NAMES = ("pls.general_train.prepare", "pls.general_train.stopper")


def read(trace, shapes):
    if not any(o.name in NAMES for o in trace.host):
        return None
    booked = idle_by_span(trace)
    return sum(booked.get(n, 0) for n in NAMES) / len(trace.calls) / 1e6
