"""capture_idle_ms.exact_gp (ms): the milliseconds a ``fit_exact_gp`` call holds
the device idle while the program runs its step's warm-up and captures the
step's CUDA graph (the spans ``pls.run_training.warmup`` and
``pls.run_training.capture``), averaged over the window's calls. None where
the trace holds no ``pls.`` span."""

from benchmark.harness.spans import idle_by_span

NAMES = ("pls.run_training.warmup", "pls.run_training.capture")


def read(trace, shapes):
    booked = idle_by_span(trace)
    if booked is None:
        return None
    return sum(booked.get(n, 0) for n in NAMES) / len(trace.calls) / 1e6
