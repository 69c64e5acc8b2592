"""drain_idle_ms.updates (ms): the milliseconds a ``train_pls`` call holds
the device idle while the program reads the stop flag after a chunk, closes
its graph and reads the results back (the spans ``pls.run_training.sync``,
``pls.run_training.close`` and ``pls.train_pls.readback``), averaged over the
window's calls. None where the trace holds no ``pls.`` span."""

from benchmark.harness.spans import idle_by_span

NAMES = ("pls.run_training.sync", "pls.run_training.close", "pls.train_pls.readback")


def read(trace, shapes):
    booked = idle_by_span(trace)
    if booked is None:
        return None
    return sum(booked.get(n, 0) for n in NAMES) / len(trace.calls) / 1e6
