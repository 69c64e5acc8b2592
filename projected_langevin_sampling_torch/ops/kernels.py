"""Covariance kernels: frozen dataclasses of parameter tensors and pure gram
functions (counterpart of ``projected_langevin_sampling_tpu/ops/kernels.py``).

A gram is built from the squared-distance expansion ``|a|^2 + |b|^2 - 2 a.b``.
On CUDA tensors every non-``diag`` ARD gram goes through the hand-written
gram kernel (``ops/cuda/gram.py``), whose autograd Function carries the
gradient to the lengthscales, the outputscale and the inputs; on CPU tensors
through its plain version, which is :func:`squared_distance` plus the exp.

"Same input" is ``x2 is None``: the squared distance of the diagonal is then
exactly 0 (gpytorch's ``x1_eq_x2`` path). Object identity is not used, since
it does not survive ``.to(device)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from projected_langevin_sampling_torch.ops.cuda.gram import ard_gram_scaled


@dataclasses.dataclass(frozen=True)
class ARDKernel:
    """Scaled RBF kernel with per-dimension (ARD) lengthscales:
    k(x1, x2) = outputscale * exp(-0.5 * sum_d ((x1_d - x2_d) / l_d)^2)."""

    lengthscales: torch.Tensor  # (D,)
    outputscale: torch.Tensor  # scalar

    @property
    def dtype(self):
        return self.lengthscales.dtype

    @property
    def device(self):
        return self.lengthscales.device

    def __call__(
        self, x1: torch.Tensor, x2: torch.Tensor | None = None, diag: bool = False
    ) -> torch.Tensor:
        return ard_gram(self, x1, x2, diag=diag)


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def squared_distance(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances (N1, D) x (N2, D) -> (N1, N2),
    clamped at 0 against the expansion's cancellation. The cross term is a
    true fp32/fp64 product (TF32 is off package-wide)."""
    x1 = _as_2d(x1)
    x2 = _as_2d(x2)
    n1 = torch.sum(torch.square(x1), dim=-1)
    n2 = torch.sum(torch.square(x2), dim=-1)
    cross = x1 @ x2.T
    return torch.clamp_min(n1[:, None] + n2[None, :] - 2.0 * cross, 0.0)


def ard_gram(
    kernel: ARDKernel,
    x1: torch.Tensor,
    x2: torch.Tensor | None = None,
    diag: bool = False,
) -> torch.Tensor:
    """Dense gram k(x1, x2); ``x2=None`` is the same-input gram, whose
    diagonal distance is exactly 0."""
    same = x2 is None
    x1 = _as_2d(x1)
    x2 = x1 if same else _as_2d(x2)
    if diag:
        d2 = torch.sum(torch.square((x1 - x2) / kernel.lengthscales), dim=-1)
        return kernel.outputscale * torch.exp(-0.5 * d2)
    scaled1 = (x1 / kernel.lengthscales).contiguous()
    scaled2 = scaled1 if same else (x2 / kernel.lengthscales).contiguous()
    return ard_gram_scaled(scaled1, scaled2, kernel.outputscale, same=same)


@dataclasses.dataclass(frozen=True)
class PLSKernel:
    """The projected kernel r(x1, x2) = (1/S) k(x1, Z) k(Z, x2) over the
    approximation samples Z (reference ``kernel.py:5-79``); extra samples
    make the set unique(concat(Z, extra)) (reference ``kernel.py:40-45``)."""

    base_kernel: ARDKernel
    approximation_samples: torch.Tensor  # (S, D)

    def forward(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        additional_approximation_samples: torch.Tensor | None = None,
        diag: bool = False,
    ) -> torch.Tensor:
        samples = self.approximation_samples
        # a zero-row extra set means "already augmented" (chunked predict)
        if (
            additional_approximation_samples is not None
            and additional_approximation_samples.shape[0] > 0
        ):
            samples = augment_approximation_samples(samples, additional_approximation_samples)
        return pls_gram(self.base_kernel, x1, x2, samples, diag=diag)

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, diag: bool = False) -> torch.Tensor:
        return self.forward(x1, x2, diag=diag)


def augment_approximation_samples(
    samples: torch.Tensor, additional: torch.Tensor
) -> torch.Tensor:
    """unique(concat(samples, additional), rows) on the host, sorted as
    ``np.unique`` sorts (and ``torch.unique(dim=0)`` in the reference)."""
    stacked = np.concatenate(
        [_as_2d(samples).cpu().numpy(), _as_2d(additional).cpu().numpy()], axis=0
    )
    return torch.as_tensor(np.unique(stacked, axis=0), device=samples.device)


def pls_gram(
    base_kernel: ARDKernel,
    x1: torch.Tensor,
    x2: torch.Tensor,
    approximation_samples: torch.Tensor,
    diag: bool = False,
) -> torch.Tensor:
    """r(x1, x2) = (1/S) k(x1, Z_s) k(Z_s, x2): two grams and one matmul;
    ``diag`` takes the row sums of the elementwise product instead of the
    whole (N1, N2) product."""
    num_samples = approximation_samples.shape[0]
    gram_1 = ard_gram(base_kernel, x1, approximation_samples)  # (N1, S)
    gram_2 = ard_gram(base_kernel, x2, approximation_samples)  # (N2, S)
    if diag:
        return torch.sum(gram_1 * gram_2, dim=-1) / num_samples
    return (gram_1 @ gram_2.T) / num_samples
