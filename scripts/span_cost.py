"""The host cost of one span of the program (``utils/tracing.span``): enter
and exit with no profiler running, the same under ``torch.profiler.profile``
(CPU and, where there is a card, CUDA activity), and a bare
``record_function`` with no profiler running, the construction the span
skips. Prints one JSON line of microseconds a span and the host it ran on.

    python3 scripts/span_cost.py [--reps 200000]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from projected_langevin_sampling_torch.utils.tracing import span  # noqa: E402


def per_span_us(enter, reps: int) -> float:
    """Best of three loops of ``reps`` enters and exits, microseconds each."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            with enter("pls.cost"):
                pass
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=200_000)
    args = parser.parse_args()
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        activities.append(ProfilerActivity.CUDA)
    off = per_span_us(span, args.reps)
    bare = per_span_us(record_function, args.reps)
    with profile(activities=activities):
        on = per_span_us(span, args.reps // 10)
    print(json.dumps({"span_off_us": off, "span_on_us": on, "record_function_off_us": bare,
                      "reps": args.reps, "host": platform.processor() or platform.machine(),
                      "cores": os.cpu_count(), "torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0) if torch.cuda.is_available()
                      else "cpu"}))


if __name__ == "__main__":
    main()
