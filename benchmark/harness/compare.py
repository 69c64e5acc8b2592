"""The numbers that decide ``correct``: how far an answer of the program lies
from the plain reference's answer to the same inputs."""

from __future__ import annotations

import torch


def leaf_gap(program: dict, reference: dict, start: dict) -> float:
    """The worst leaf's gap: max over leaves of |program - reference| (the
    largest element) over the largest element of the reference's change
    from ``start``. A leaf the reference leaves where it started has no
    scale and is not counted."""
    worst = 0.0
    for name, ref in reference.items():
        ref = ref.double()
        change = float(torch.max(torch.abs(ref - start[name].double())))
        if change == 0.0:
            continue
        gap = float(torch.max(torch.abs(program[name].double() - ref)))
        worst = max(worst, gap / change if gap == gap else float("inf"))
    return worst


def trace_gap(program: list[float], reference: list[float]) -> float:
    """The widest gap between two traces of losses or energies, over the
    reference's largest magnitude; a trace of another length reads inf."""
    if len(program) != len(reference) or not reference:
        return float("inf")
    scale = max(abs(v) for v in reference)
    gap = max(abs(a - b) for a, b in zip(program, reference))
    return gap / scale if gap == gap and scale > 0 else float("inf")
