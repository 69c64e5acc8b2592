"""unspanned_idle_ms.updates (ms): the milliseconds a ``train_pls`` call holds
the device idle under no span of the program (``pls.``): before and after
the program's outer span, inside the benchmark's own span around the call,
averaged over the window's calls. None where the trace holds no ``pls.``
span."""

from benchmark.harness.spans import idle_by_span

NAMES = ("unspanned",)


def read(trace, shapes):
    booked = idle_by_span(trace)
    if booked is None:
        return None
    return sum(booked.get(n, 0) for n in NAMES) / len(trace.calls) / 1e6
