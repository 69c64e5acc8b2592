"""The residual-smoothed Bernoulli cost and its derivative in one pass
(``csrc/smoothed_bernoulli.cu``), and its plain version.

Replaces no TPU kernel: the JAX package runs the Gauss-Hermite quadrature of
``models/costs/smoothed_bernoulli.py`` as XLA elementwise code in its ``off``
tier. For F (N, J), labels y (N,), stds s (N,) and a rule (nodes, weights)
of any length Q it returns

    cost[j]  = sum_i [E_q softplus(F_ij + sqrt(2) s_i x_q) - y_i F_ij]
    dc[i, j] = E_q sigmoid(F_ij + sqrt(2) s_i x_q) - y_i

with E_q the rule's weighted sum over sqrt(pi): the values of
``SmoothedBernoulliCost.calculate_cost`` and ``calculate_cost_derivative``.

Bound on the H100: fp64 arithmetic (a log1p, a reciprocal and a few FMAs an
element and node), not bytes (F read once, dc written once). One exp an
element stands in for the exp of every node, and each column's cost is
summed in a fixed order, so a rerun is bitwise equal; see the note in
``csrc/smoothed_bernoulli.cu``.

:func:`smoothed_bernoulli` launches the kernel on CUDA tensors (2 launches
on the current stream, fp64 in fp64 and fp32 in fp32) and raises on
anything else. :func:`smoothed_bernoulli_reference` is its plain version,
the arithmetic of the cost's two methods, which are the CPU path (the cost
sends a CPU F to them). ``smoothed_bernoulli.launches`` counts launched
calls, graph replays included (``utils/early_stopper.REPLAYED_COUNTERS``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from projected_langevin_sampling_torch.ops.cuda import build
from projected_langevin_sampling_torch.ops.cuda.cost_forms import softplus
from projected_langevin_sampling_torch.utils.early_stopper import count_replays

_SIGNATURES = {"plst_smoothed_bernoulli": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p]}
# the kernel's block (csrc/smoothed_bernoulli.cu): rows at most, threads, and
# the shared memory it may take without opting in (its lane sums, a value a
# thread, included)
ROWS_PER_BLOCK = 16
_THREADS = 256
_SHARED_BYTES = 48 * 1024


def gauss_hermite_mean(f: torch.Tensor, smoothing_std: torch.Tensor, nodes: torch.Tensor,
                       weights: torch.Tensor, fn) -> torch.Tensor:
    """E_z[fn(F + s z)], z ~ N(0, 1), by Gauss-Hermite, accumulated node by
    node so that only (N, J) buffers are live, never an (N, J, Q) one."""
    scale = math.sqrt(2.0) * smoothing_std[:, None]
    acc = torch.zeros_like(f)
    for q in range(nodes.shape[0]):
        acc = acc + weights[q] * fn(f + scale * nodes[q])
    return acc / math.sqrt(math.pi)


def smoothed_bernoulli_reference(
    f: torch.Tensor, y: torch.Tensor, smoothing_std: torch.Tensor, nodes: torch.Tensor,
    weights: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cost (J,), dc (N, J)): the kernel's function in plain PyTorch, the
    cost's two methods' arithmetic."""
    cost = torch.sum(gauss_hermite_mean(f, smoothing_std, nodes, weights, softplus)
                     - y[:, None] * f, dim=0)
    dc = gauss_hermite_mean(f, smoothing_std, nodes, weights, torch.sigmoid) - y[:, None]
    return cost, dc


def rows_per_block(q: int, itemsize: int) -> int:
    """Rows a block of the kernel takes: its shared memory holds the rule,
    3 Q + 2 values a row and a lane sum a thread; 0 where not even one row
    fits."""
    return max(0, min(ROWS_PER_BLOCK, (_SHARED_BYTES // itemsize - _THREADS - q) // (3 * q + 2)))


def _check(f, y, smoothing_std, nodes, weights) -> None:
    """Raise on what the kernel does not take."""
    if f.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"smoothed_bernoulli: F of dtype {f.dtype} (float32 or float64 only)")
    if f.ndim != 2 or min(f.shape) == 0:
        raise ValueError(f"smoothed_bernoulli: F of shape {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("smoothed_bernoulli: F is not contiguous")
    n = f.shape[0]
    q = nodes.shape[0] if nodes.ndim == 1 else -1
    for name, t, length in (("y", y, n), ("smoothing_std", smoothing_std, n),
                            ("nodes", nodes, q), ("weights", weights, q)):
        if t.ndim != 1 or t.shape[0] != length or length < 1:
            raise ValueError(f"smoothed_bernoulli: {name} of shape {tuple(t.shape)} for F of "
                             f"shape {tuple(f.shape)} and {q} nodes")
        if t.dtype != f.dtype or t.device != f.device or not t.is_contiguous():
            raise ValueError(f"smoothed_bernoulli: {name} is {t.dtype} on {t.device} "
                             f"(contiguous: {t.is_contiguous()}), F {f.dtype} on {f.device}")
    if f.requires_grad and torch.is_grad_enabled():
        raise ValueError("smoothed_bernoulli: the kernel has no gradient")
    rows = rows_per_block(q, f.element_size())
    if rows < 1:
        raise ValueError(f"smoothed_bernoulli: a rule of {q} nodes does not fit a block")
    if f.numel() >= 2**31 or -(-n // rows) > 65535:
        raise ValueError(f"smoothed_bernoulli: F of shape {tuple(f.shape)} is too large")


def smoothed_bernoulli(
    f: torch.Tensor, y: torch.Tensor, smoothing_std: torch.Tensor, nodes: torch.Tensor,
    weights: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cost (J,), dc (N, J)) of F (N, J) in F's dtype, by the kernel. Every
    input is a contiguous CUDA tensor of F's dtype (float32 or float64) on
    F's device."""
    _check(f, y, smoothing_std, nodes, weights)
    if f.device.type != "cuda":
        raise ValueError(f"smoothed_bernoulli: F on {f.device}")
    n, j = f.shape
    q = nodes.shape[0]
    rows = rows_per_block(q, f.element_size())
    with torch.cuda.device(f.device):
        cost = torch.empty(j, dtype=f.dtype, device=f.device)
        dc = torch.empty_like(f)
        partials = torch.empty(j * -(-n // rows), dtype=f.dtype, device=f.device)
        err = build.load("smoothed_bernoulli", _SIGNATURES).plst_smoothed_bernoulli(
            f.data_ptr(), y.data_ptr(), smoothing_std.data_ptr(), nodes.data_ptr(),
            weights.data_ptr(), dc.data_ptr(), cost.data_ptr(), partials.data_ptr(), n, j, q,
            rows, int(f.dtype == torch.float64), torch.cuda.current_stream().cuda_stream,
        )
        build.check(err, "smoothed_bernoulli kernel")
    smoothed_bernoulli.launches += 1
    return cost, dc


smoothed_bernoulli.launches = 0
count_replays(smoothed_bernoulli, "launches")
