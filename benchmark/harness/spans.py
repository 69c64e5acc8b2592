"""The device's idle time inside the calls, booked to the program's stages.

The program opens ranges named ``pls.*`` at the stages of a call (the
capture of a step's graph, a chunk's replays, the reads of the stop flag
and of the losses; ``projected_langevin_sampling_torch/utils/tracing.py``).
Under the profiler they are host operations of the :class:`Trace`, on the
clock of the device's operations.
"""

from __future__ import annotations

import collections
import functools

from benchmark.harness.timing import Trace


# a cell's three metrics read one trace: book its idle once
@functools.lru_cache(maxsize=1)
def idle_by_span(trace: Trace) -> dict[str, int] | None:
    """Nanoseconds of device idle inside the calls' spans over the window, by
    the innermost ``pls.`` span open at each idle instant (the latest start
    among the spans that cover it), ``"unspanned"`` where none is open.

    A call's idle is its span less the union of the device operations that
    start inside it, clipped to it, as ``readers.host_ms_per_call`` reads
    it: the values sum to that reading times the calls. None where the
    trace holds no ``pls.`` span (a program without them)."""
    spans = [o for o in trace.host if o.name.startswith("pls.")]
    if not spans:
        return None
    booked = collections.Counter()
    for c in trace.calls:
        idle, cursor = [], c.start_ns
        for o in trace.ops_in(c.start_ns, c.end_ns):
            if o.start_ns > cursor:
                idle.append((cursor, o.start_ns))
            cursor = max(cursor, min(o.end_ns, c.end_ns))
        if cursor < c.end_ns:
            idle.append((cursor, c.end_ns))
        # the spans' ends cut the call into pieces, each under one innermost span
        inside = [s for s in spans if s.start_ns < c.end_ns and s.end_ns > c.start_ns]
        cuts = sorted({c.start_ns, c.end_ns} | {min(max(t, c.start_ns), c.end_ns)
                                                 for s in inside for t in (s.start_ns, s.end_ns)})
        pieces = []
        for a, b in zip(cuts, cuts[1:]):
            cover = [s for s in inside if s.start_ns <= a and s.end_ns >= b]
            name = max(cover, key=lambda s: (s.start_ns, -s.end_ns)).name if cover else "unspanned"
            pieces.append((b, name))
        i = 0
        for a, b in idle:
            while a < b:
                while pieces[i][0] <= a:
                    i += 1
                end = min(b, pieces[i][0])
                booked[pieces[i][1]] += end - a
                a = end
    return dict(booked)
