"""Named spans of the program on the torch profiler's clock.

``with span("pls.run_training.capture"):`` opens a host range while a
profiler is running, an event of the same trace as the device's kernels;
with no profiler running it is one shared null context, and nothing is
constructed. The range is torch's fast record function (a ``cpu_op`` event,
as an operator's), not ``torch.profiler.record_function``: that one's user
annotation is mirrored onto the device's timeline, where a reader of device
time takes it for work. Spans sit at a run's stages (capture, chunks, flag
reads, read-back), never inside a captured step. Every name starts with
``pls.``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named ``name`` while a profiler runs, else a null
    context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
