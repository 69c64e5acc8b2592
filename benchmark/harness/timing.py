"""Device timing and the reduction of a profiler trace to what the per-layer
metrics read.

``cuda_ms`` and ``profiled_device_split`` are frozen copies of
``chip_smoke.py``'s helpers. :class:`Trace` holds one traced window: the
device's operations (kernels, copies, sets), the host's operations, and the
benchmark's own spans around each call into the program, all on the
profiler's clock.
"""

from __future__ import annotations

import bisect
import collections
from typing import NamedTuple

import torch

SPAN = "bench.call"
DEVICE_KINDS = ("kernel", "memcpy", "memset")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, between CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_device_split(fn, kernel_names, reps: int, warmup: bool = True):
    """Device milliseconds per call of each of ``kernel_names``, the kernels
    whose names contain it (the first name that matches takes a kernel), from
    the profiler's CUDA activity; a name the trace shows no time for gets
    None."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = dict.fromkeys(kernel_names, 0.0)
    for e in prof.key_averages():
        name = next((k for k in kernel_names if k in e.key), None)
        if name is not None:
            total_us[name] += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    return {k: (us / 1e3 / reps if us > 0 else None) for k, us in total_us.items()}


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    kind: str = "host"  # kernel, memcpy or memset on the device


class Call(NamedTuple):
    """One call into the program inside the window: its span on the host
    and the work it completed (epochs or particle updates)."""

    start_ns: int
    end_ns: int
    work: float


def _device_kind(event) -> str | None:
    """``kernel``, ``memcpy`` or ``memset`` for a device operation, None for
    anything else (annotations the profiler mirrors onto the device)."""
    kind = str(event.activity_type()).lower() if hasattr(event, "activity_type") else ""
    name = event.name()
    if "annotation" in kind or name.startswith("bench."):
        return None
    for k in DEVICE_KINDS:
        if k in kind or k in name.lower():
            return k
    return "kernel"


class Trace:
    """One traced window. ``device`` holds the device operations sorted by
    start, ``host`` the host operations, ``calls`` the benchmark's spans with
    the work each call completed."""

    def __init__(self, device: list[Op], host: list[Op], calls: list[Call]):
        self.device = sorted(device, key=lambda o: o.start_ns)
        self.host = sorted(host, key=lambda o: o.start_ns)
        self.calls = calls
        self._host_starts = [o.start_ns for o in self.host]
        self._device_starts = [o.start_ns for o in self.device]

    @classmethod
    def from_profiler(cls, prof, work: list[float]) -> Trace:
        """Read a finished ``torch.profiler.profile``; ``work`` is the work of
        each call, in the order of the spans."""
        device, host, spans = [], [], []
        for e in prof.profiler.kineto_results.events():
            start = int(e.start_ns())
            op = Op(e.name(), start, start + int(e.duration_ns()))
            if "cuda" in str(e.device_type()).lower():
                kind = _device_kind(e)
                if kind is not None:
                    device.append(op._replace(kind=kind))
            elif op.name == SPAN:
                spans.append(op)
            else:
                host.append(op)
        spans.sort(key=lambda o: o.start_ns)
        if len(spans) != len(work):
            raise RuntimeError(f"the trace holds {len(spans)} call spans for {len(work)} calls")
        calls = [Call(s.start_ns, s.end_ns, w) for s, w in zip(spans, work)]
        return cls(device, host, calls)

    # --- the window ---------------------------------------------------------
    @property
    def window_ns(self) -> tuple[int, int]:
        return self.calls[0].start_ns, self.calls[-1].end_ns

    @property
    def window_s(self) -> float:
        a, b = self.window_ns
        return (b - a) / 1e9

    @property
    def work(self) -> float:
        return sum(c.work for c in self.calls)

    def ops_in(self, start_ns: int, end_ns: int) -> list[Op]:
        """Device operations that start inside [start_ns, end_ns)."""
        lo = bisect.bisect_left(self._device_starts, start_ns)
        hi = bisect.bisect_left(self._device_starts, end_ns)
        return self.device[lo:hi]

    def call_ops(self) -> list[Op]:
        """Device operations that start inside some call's span."""
        ops = []
        for c in self.calls:
            ops.extend(self.ops_in(c.start_ns, c.end_ns))
        return ops

    @staticmethod
    def busy_ns(ops: list[Op], start_ns: int | None = None, end_ns: int | None = None) -> int:
        """Length of the union of the operations' intervals, clipped to
        [start_ns, end_ns] where given."""
        total, cur_a, cur_b = 0, None, None
        for o in sorted(ops, key=lambda o: o.start_ns):
            a = o.start_ns if start_ns is None else max(o.start_ns, start_ns)
            b = o.end_ns if end_ns is None else min(o.end_ns, end_ns)
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total

    @property
    def busy_s(self) -> float:
        a, b = self.window_ns
        return self.busy_ns(self.ops_in(a, b), a, b) / 1e9

    def device_s(self, ops: list[Op]) -> float:
        """Summed durations of ``ops`` in seconds."""
        return sum(o.end_ns - o.start_ns for o in ops) / 1e9

    # --- the breakdown ------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations (by name) that took most time."""
        a, b = self.window_ns
        totals = collections.Counter()
        for o in self.ops_in(a, b):
            totals[o.name] += o.end_ns - o.start_ns
        return [[name, ns / 1e9] for name, ns in totals.most_common(n)]

    def _host_at(self, t_ns: int) -> str:
        """The innermost host operation running at ``t_ns``."""
        i = bisect.bisect_right(self._host_starts, t_ns)
        for j in range(i - 1, max(i - 4000, -1), -1):
            if self.host[j].end_ns >= t_ns:
                return self.host[j].name
        return "benchmark loop"

    def idle_gaps(self, n: int = 10, min_gap_ns: int = 20_000) -> list[list]:
        """Idle time of the device inside the window, summed by what the host
        was doing when each gap began; gaps under ``min_gap_ns`` go under one
        name of their own."""
        a, b = self.window_ns
        totals = collections.Counter()
        cursor = a
        for o in self.ops_in(a, b):
            if o.start_ns > cursor:
                gap = o.start_ns - cursor
                key = self._host_at(cursor) if gap >= min_gap_ns else "gaps under 20 us"
                totals[key] += gap
            cursor = max(cursor, o.end_ns)
        if b > cursor:
            totals[self._host_at(cursor)] += b - cursor
        return [[name, ns / 1e9] for name, ns in totals.most_common(n)]
