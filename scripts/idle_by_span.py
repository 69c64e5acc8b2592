"""A traced run of one benchmark cell that also prints the device idle booked
to every span of the program, not only the three stages the per-layer
metrics read (``benchmark/harness/spans.idle_by_span``). It takes
``benchmark/run.py``'s arguments, prints that script's output, then one more
JSON line: the calls, ``train_host_ms``' reading (the calls' idle), the
booked idle's sum and its milliseconds a call by span.

    python3 scripts/idle_by_span.py --workload <cell> --seed <n> --seconds 51 --trace 1
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import spans, timing  # noqa: E402
from benchmark.harness.readers import host_ms_per_call  # noqa: E402

held = {}
_from_profiler = timing.Trace.from_profiler.__func__


def _keep(cls, prof, work):
    held["trace"] = _from_profiler(cls, prof, work)
    return held["trace"]


def main() -> int:
    import benchmark.run as run

    timing.Trace.from_profiler = classmethod(_keep)
    rc = run.main(sys.argv[1:])
    if "trace" not in held:
        return rc or 1
    trace = held["trace"]
    booked = spans.idle_by_span(trace) or {}
    n = len(trace.calls)
    print(json.dumps({"rc": rc, "calls": n, "host_ms_per_call": host_ms_per_call(trace),
                      "booked_sum_ms_per_call": sum(booked.values()) / n / 1e6,
                      "booked_ms_per_call": {k: v / n / 1e6 for k, v in
                                             sorted(booked.items(), key=lambda kv: -kv[1])},
                      "busy_s": trace.busy_s, "window_s": trace.window_s}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
