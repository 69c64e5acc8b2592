"""Plain PyTorch pieces the references share: the ARD kernel by direct
differences, the projected r-kernel, and gpytorch's escalating-jitter
Cholesky. Nothing here imports the program or JAX."""

from __future__ import annotations

import torch


def ard(x1: torch.Tensor, x2: torch.Tensor | None, lengthscales, outputscale) -> torch.Tensor:
    """outputscale exp(-0.5 sum_d ((x1_d - x2_d) / l_d)^2), summed dimension
    by dimension from the differences themselves (no |a|^2 + |b|^2 - 2ab
    expansion); ``x2=None`` is the same-input gram, whose diagonal is then
    the outputscale exactly."""
    x2 = x1 if x2 is None else x2
    d2 = torch.zeros((x1.shape[0], x2.shape[0]), dtype=x1.dtype, device=x1.device)
    for d in range(x1.shape[1]):
        d2 = d2 + torch.square((x1[:, d, None] - x2[None, :, d]) / lengthscales[d])
    return outputscale * torch.exp(-0.5 * d2)


def ard_diag(x: torch.Tensor, outputscale) -> torch.Tensor:
    return outputscale * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


def r_gram(x1, x2, z, lengthscales, outputscale) -> torch.Tensor:
    """The projected kernel r(x1, x2) = (1/M) k(x1, Z) k(Z, x2)."""
    return ard(x1, z, lengthscales, outputscale) @ ard(x2, z, lengthscales, outputscale).T / z.shape[0]


def r_diag(x, z, lengthscales, outputscale) -> torch.Tensor:
    k = ard(x, z, lengthscales, outputscale)
    return torch.sum(k * k, dim=1) / z.shape[0]


def jitter_floor(dtype) -> float:
    """gpytorch's psd_safe_cholesky floor: 1e-6 in fp32, 1e-8 in fp64."""
    return 1e-6 if dtype == torch.float32 else 1e-8


def safe_cholesky(matrix: torch.Tensor, jitter: float, tries: int = 3) -> torch.Tensor:
    """gpytorch's psd_safe_cholesky: the factor of matrix + jitter I, else of
    matrix + jitter 10^k I for the first k in 1..tries that factors."""
    eye = torch.eye(matrix.shape[0], dtype=matrix.dtype, device=matrix.device)
    for k in range(tries + 1):
        chol, info = torch.linalg.cholesky_ex(matrix + jitter * 10.0**k * eye)
        if int(info) == 0 and bool(torch.isfinite(chol).all()):
            return chol
    raise ValueError(f"no factor with jitter up to {jitter * 10.0**tries:g}")
