"""B2: the ARD-RBF gram kernel (``csrc/gram.cu``) and its plain version.

Replaces ``projected_langevin_sampling_tpu/ops/pallas/gram.py``
(``pallas_ard_gram``), and takes over the safeguards of ``ard_gram`` that the
TPU kernel omits: the cross term in true fp32 or fp64, the distance clamped
at 0, and an exact-zero diagonal for a same-input gram.

Bound on the H100: the output bytes (a few dozen operations per element for
D <= 20 against 4 or 8 bytes written). For small D a thread holds a strip
of 16 bytes of columns in registers and writes each of its rows' strips with
one 16-byte store, with no shared memory and no barrier; larger D stages
32-row tiles of both inputs in shared memory. The kernel's entry point picks
the path, the grid and the store width; see the note in ``csrc/gram.cu``.

:func:`ard_gram_scaled` launches the kernel for CUDA tensors and uses the
plain version only for tensors that lie on the CPU. On the card the launch
sits inside :class:`ARDGram`, a ``torch.autograd.Function`` whose backward
is plain torch (:func:`ard_gram_scaled_backward`), so the GP fits get the
gradient of every gram in lengthscales, outputscale and inputs. An
outputscale tensor on the card reaches the kernel by its address, never
read on the host: a GP step is captured into a CUDA graph
(``utils/early_stopper.py``) and replays the launch with each step's value.
"""

from __future__ import annotations

import ctypes

import torch

from projected_langevin_sampling_torch.ops.cuda import build
from projected_langevin_sampling_torch.utils.early_stopper import count_replays

_ENTRY = {torch.float32: "plst_ard_gram_f32", torch.float64: "plst_ard_gram_f64"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]


def _entry(dtype):
    fn = getattr(build.load("gram"), _ENTRY[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def ard_gram_scaled_reference(
    x1: torch.Tensor, x2: torch.Tensor, outputscale, same: bool = False
) -> torch.Tensor:
    """The plain PyTorch version: ``squared_distance`` plus the exp. Made of
    ordinary torch ops, so autograd differentiates it."""
    from projected_langevin_sampling_torch.ops.kernels import squared_distance

    d2 = squared_distance(x1, x2)
    if same:
        d2.fill_diagonal_(0.0)
    return outputscale * torch.exp(-0.5 * d2)


def ard_gram_scaled_backward(
    grad: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    gram: torch.Tensor,
    outputscale,
    same: bool = False,
):
    """The gradients of ``sum(grad * gram)`` with respect to ``x1``, ``x2``
    and the outputscale, given the forward's ``gram``.

    With W = grad * gram: dL/dx1 = W x2 - rowsum(W) x1, dL/dx2 = W^T x1 -
    colsum(W) x2 and dL/ds = sum(W) / s. An entry whose squared distance the
    forward clamped at 0, or zeroed on a same-input diagonal, carries no
    distance gradient, as JAX's autodiff of ``jnp.maximum`` and
    ``fill_diagonal`` gives; the gram is exactly ``s`` at those entries
    (exp(0) = 1), which marks them. Plain torch: two products and an
    elementwise pass (the JAX package differentiates XLA's matmul expansion
    and has no backward kernel either)."""
    s = _value(outputscale)
    w = grad * gram
    w_dist = torch.where(gram == s, 0.0, w)  # s in the gram's dtype, as the kernel has it
    g1 = w_dist @ x2 - w_dist.sum(dim=1, keepdim=True) * x1
    g2 = w_dist.T @ x1 - w_dist.sum(dim=0)[:, None] * x2
    gs = w.sum() / s
    return g1, g2, gs


def _value(outputscale):
    """The outputscale without its autograd graph: a float, or a tensor that
    stays on its device (reading it on the host would wait for the card)."""
    if isinstance(outputscale, torch.Tensor):
        return outputscale.detach()
    return float(outputscale)


def _launch(x1: torch.Tensor, x2: torch.Tensor, outputscale, same: bool) -> torch.Tensor:
    if x1.device.type != "cuda" or x1.device != x2.device:
        raise ValueError(f"ard_gram_scaled: inputs on {x1.device} and {x2.device}")
    if x1.dtype not in _ENTRY or x2.dtype != x1.dtype:
        raise TypeError(f"ard_gram_scaled: dtypes {x1.dtype}, {x2.dtype}; needs fp32 or fp64")
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"ard_gram_scaled: shapes {tuple(x1.shape)}, {tuple(x2.shape)}")
    if not (x1.is_contiguous() and x2.is_contiguous()):
        raise ValueError("ard_gram_scaled: inputs must be contiguous")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if same and n1 != n2:
        raise ValueError("ard_gram_scaled: same=True needs one input")
    scale = None
    if isinstance(outputscale, torch.Tensor):
        if outputscale.numel() != 1 or outputscale.device != x1.device:
            raise ValueError(f"ard_gram_scaled: outputscale {tuple(outputscale.shape)} on "
                             f"{outputscale.device}; needs one value on {x1.device}")
        scale = outputscale.detach().to(x1.dtype).contiguous()
    out = torch.empty((n1, n2), dtype=x1.dtype, device=x1.device)
    with torch.cuda.device(x1.device):  # the launch goes to the current device
        err = _entry(x1.dtype)(
            x1.data_ptr(), x2.data_ptr(), out.data_ptr(), n1, n2, d,
            0.0 if scale is not None else float(outputscale),
            None if scale is None else scale.data_ptr(), int(same),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, f"ard_gram kernel (N1={n1}, N2={n2}, D={d})")
    ard_gram_scaled.launches += 1
    return out


class ARDGram(torch.autograd.Function):
    """B2 with a gradient: the forward launches ``csrc/gram.cu`` on CUDA
    tensors (the plain version on CPU tensors, for the tests) and saves the
    gram; the backward is :func:`ard_gram_scaled_backward`. For a same-input
    gram pass the one input as both ``x1`` and ``x2``: autograd adds the two
    input gradients on it. ``outputscale`` may be a tensor: the kernel reads
    its value on the device, and its gradient reaches the tensor."""

    backward_calls = 0  # backward passes run, on either device

    @staticmethod
    def forward(ctx, x1, x2, outputscale, same):
        s = _value(outputscale)
        if isinstance(s, torch.Tensor):
            s = s.to(x1.dtype)  # as a float would enter the gram's dtype
        if x1.device.type == "cpu" and x2.device.type == "cpu":
            gram = ard_gram_scaled_reference(x1, x2, s, same)
        else:
            gram = _launch(x1, x2, s, same)
        ctx.same = same
        ctx.outputscale = s
        ctx.save_for_backward(x1, x2, gram)
        return gram

    @staticmethod
    def backward(ctx, grad):
        x1, x2, gram = ctx.saved_tensors
        ARDGram.backward_calls += 1
        g1, g2, gs = ard_gram_scaled_backward(grad, x1, x2, gram, ctx.outputscale, ctx.same)
        if not ctx.needs_input_grad[2]:
            gs = None
        return g1, g2, gs, None


def ard_gram_scaled(
    x1: torch.Tensor, x2: torch.Tensor, outputscale, same: bool = False
) -> torch.Tensor:
    """``outputscale * exp(-0.5 * max(|x1|^2 + |x2|^2 - 2 x1 x2^T, 0))``.

    ``x1`` (N1, D) and ``x2`` (N2, D) are already divided by the
    lengthscales; ``same=True`` (the caller passed one input) zeroes the
    squared distance on the diagonal. ``outputscale`` is a float or a scalar
    tensor. CUDA tensors go through the kernel inside :class:`ARDGram`, so
    the gram carries a gradient to both inputs and the outputscale; CPU
    tensors through :func:`ard_gram_scaled_reference`, which autograd
    differentiates."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return ard_gram_scaled_reference(x1, x2, outputscale, same)
    return ARDGram.apply(x1, x2, outputscale, same)


ard_gram_scaled.launches = 0
count_replays(ard_gram_scaled, "launches")
count_replays(ARDGram, "backward_calls")
