"""The closed-form costs of the card's kernels B3 (``ops/cuda/general_train.py``)
and B5 (``ops/cuda/fused_update.py``) in plain PyTorch, and their shared
facts; ``csrc/cost_forms.cuh`` is their CUDA form.

A kind is a cost and link whose value and derivative in F the kernels compute
by a formula. :data:`KINDS` lists them in the order of the CUDA ``CostKind``
enum, each with its operation counts and whether its first parameter is the
link's jitter. B3 instantiates every kind; B5 the kinds it has a count for
(dc alone). :func:`cost_and_dc` is the one plain form of both; which cost
and link take which kind is decided above this layer (``closed_forms.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# fp32 operations per element of F for the bounds in PERF.md and chip_smoke.py,
# besides the products. A precise expf is counted as 8 instructions, log1pf and
# erff as 20, a precise divide as 8; an add, multiply, compare or select as 1
# and an FMA as 2. Estimates, not counts of the compiled code.
_EXP, _LOG, _DIV = 8, 20, 8
_SIGMOID = _EXP + 1 + _DIV
_SOFTPLUS = 3 + _EXP + _LOG


class Kind(NamedTuple):
    ops: int  # operations of the cost and dc (B3's epilogue)
    dc_ops: int | None  # of dc alone (B5's epilogue); None: B5 has no instance of the kind
    jitter: bool  # p0 is the link's jitter: the clip's floor is max(p0, the dtype's eps)


KINDS = {
    "gaussian": Kind(3 + _DIV + 4, 1 + _DIV, False),
    "bernoulli_sigmoid": Kind(_SIGMOID + 4 + 2 * _LOG + 6 + 1, _EXP + 2 + _DIV + 2 + 6, True),
    "bernoulli_sigmoid_smoothed": Kind(2 + 16 * (2 + _SOFTPLUS + _SIGMOID + 4), None, False),
    "bernoulli_probit": Kind(2 + _LOG + 6 + _EXP + 3 + 2 * _LOG + 6 + 3 + _DIV + 2, None, True),
    "poisson_square": Kind(2 + _LOG + 4 + _DIV + 3, 2 + _DIV + 3, False),
    "student_t": Kind(1 + 2 + _DIV + _LOG + 3 + 3 + _DIV, 3 + _DIV + 4, False),
    "multimodal_identity": Kind(4 + _DIV + 2 * _LOG + _SOFTPLUS + _SIGMOID + 2 * _DIV + 8, None,
                                False),
}
COST_KINDS = tuple(KINDS)  # the CUDA enum's order

# the physicists' 16-node Gauss-Hermite rule of the smoothed kind, scaled as
# the kernel applies it: E_z[g(f + s z)] = sum_q w_q / sqrt(pi) g(f + sqrt(2) x_q s)
GH16_NODES, GH16_WEIGHTS = np.polynomial.hermite.hermgauss(16)
GH16_SCALED_NODES = math.sqrt(2.0) * GH16_NODES
GH16_SCALED_WEIGHTS = GH16_WEIGHTS / math.sqrt(math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)`` = max(x, 0) + log1p(e^-|x|), the
    JAX form (torch's own softplus switches to x above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def cost_and_dc(kind: str, f: torch.Tensor, y: torch.Tensor, aux: torch.Tensor | None, params):
    """Elementwise cost and dc (N, J) of a cost kind, the kernels' closed
    forms (``_tile_cost_and_dc``) in the input's dtype; ``y`` and ``aux`` (the
    smoothed kind's stds, None for the others) are (N, 1). For the Bernoulli
    kinds p0 is the link's jitter and the clip's floor max(p0, dtype eps)."""
    p0, p1, p2 = params
    if kind == "gaussian":
        err = f - y
        return (0.5 / p0) * torch.square(err), err / p0
    if kind == "bernoulli_sigmoid":
        jit = max(p0, torch.finfo(f.dtype).eps)
        p = torch.clamp(torch.sigmoid(f), jit, 1.0 - jit)
        return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)), p - y
    if kind == "bernoulli_sigmoid_smoothed":
        cost, dc = -y * f, -y.expand_as(f)
        for node, weight in zip(GH16_SCALED_NODES.tolist(), GH16_SCALED_WEIGHTS.tolist()):
            zq = f + node * aux
            cost = cost + weight * softplus(zq)
            dc = dc + weight * torch.sigmoid(zq)
        return cost, dc
    if kind == "bernoulli_probit":
        jit = max(p0, torch.finfo(f.dtype).eps)
        cdf = 0.5 * (1.0 + torch.erf(f * (0.5**0.5)))
        in_range = (cdf > jit) & (cdf < 1.0 - jit)
        p = torch.clamp(cdf, jit, 1.0 - jit)
        pdf = torch.exp(-0.5 * torch.square(f)) * (1.0 / math.sqrt(2.0 * math.pi))
        cost = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        dc = torch.where(in_range, pdf * (p - y) / (p * (1.0 - p)), torch.zeros_like(f))
        return cost, dc
    if kind == "poisson_square":
        return -2.0 * y * torch.log(torch.abs(f)) + torch.square(f), -2.0 * y / f + 2.0 * f
    if kind == "student_t":
        err = f - y
        denom = p0 * (p1 * p1)
        cost = 0.5 * (p0 + 1.0) * torch.log1p(torch.square(err) / denom)
        return cost, (p0 + 1.0) * err / (denom + torch.square(err))
    if kind == "multimodal_identity":
        sigma2 = p0 * p0
        err = y - f
        b = math.log(p2) - math.log1p(-p2)
        delta = -(p1 * err + 0.5 * p1 * p1) / sigma2
        log_norm = 0.5 * math.log(2.0 * math.pi * sigma2)
        cost = 0.5 * torch.square(err) / sigma2 + log_norm - math.log1p(-p2) - softplus(b + delta)
        return cost, -(err + torch.sigmoid(b + delta) * p1) / sigma2
    raise ValueError(f"Unknown cost kind {kind!r}")
