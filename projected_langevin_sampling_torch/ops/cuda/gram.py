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
plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from projected_langevin_sampling_torch.ops.cuda import build

_ENTRY = {torch.float32: "plst_ard_gram_f32", torch.float64: "plst_ard_gram_f64"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
]


def _entry(dtype):
    fn = getattr(build.load("gram"), _ENTRY[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def ard_gram_scaled_reference(
    x1: torch.Tensor, x2: torch.Tensor, outputscale: float, same: bool = False
) -> torch.Tensor:
    """The plain PyTorch version: ``squared_distance`` plus the exp."""
    from projected_langevin_sampling_torch.ops.kernels import squared_distance

    d2 = squared_distance(x1, x2)
    if same:
        d2.fill_diagonal_(0.0)
    return outputscale * torch.exp(-0.5 * d2)


def ard_gram_scaled(
    x1: torch.Tensor, x2: torch.Tensor, outputscale: float, same: bool = False
) -> torch.Tensor:
    """``outputscale * exp(-0.5 * max(|x1|^2 + |x2|^2 - 2 x1 x2^T, 0))``.

    ``x1`` (N1, D) and ``x2`` (N2, D) are already divided by the
    lengthscales; ``same=True`` (the caller passed one input) zeroes the
    squared distance on the diagonal. CUDA tensors go through the kernel;
    CPU tensors through :func:`ard_gram_scaled_reference`."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return ard_gram_scaled_reference(x1, x2, outputscale, same)
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
    out = torch.empty((n1, n2), dtype=x1.dtype, device=x1.device)
    with torch.cuda.device(x1.device):  # the launch goes to the current device
        err = _entry(x1.dtype)(
            x1.data_ptr(), x2.data_ptr(), out.data_ptr(), n1, n2, d,
            float(outputscale), int(same), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, f"ard_gram kernel (N1={n1}, N2={n2}, D={d})")
    ard_gram_scaled.launches += 1
    return out


ard_gram_scaled.launches = 0
