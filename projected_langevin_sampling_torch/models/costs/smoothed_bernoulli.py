"""Residual-smoothed Bernoulli cost (counterpart of
``projected_langevin_sampling_tpu/models/costs/smoothed_bernoulli.py``).

The FITC-style expected log-likelihood: each training point is scored
through ``E_{z ~ N(0, 1)}[log p(y_i | f_i + s_i z)]``, where ``s_i^2`` is the
latent variance the rank-M_k basis leaves out (:func:`residual_smoothing_std`):

    cost_j = sum_i (E_z[softplus(F_ij + s_i z)] - y_i F_ij)
    d cost_j / d F_ij = E_z[sigmoid(F_ij + s_i z)] - y_i

by Gauss-Hermite quadrature. With ``smoothing_std == 0`` both reduce to the
sigmoid ``BernoulliCost``. It is a class of its own, not a ``BernoulliCost``
subclass, so that the general kernel's cost dispatch cannot mistake it for
the plain sigmoid kind.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.distributions import Bernoulli
from projected_langevin_sampling_torch.models.link_functions import (
    PLSLinkFunction,
    SigmoidLinkFunction,
)
from projected_langevin_sampling_torch.utils.device import as_tensor


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)`` = max(x, 0) + log1p(e^-|x|), the
    JAX form (torch's own softplus switches to x above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


@dataclasses.dataclass(frozen=True)
class SmoothedBernoulliCost(PLSCostMixin):
    """Bernoulli cost under Gauss-Hermite smoothing with per-point stds.
    Build it with :func:`make_smoothed_bernoulli_cost`."""

    y_train: torch.Tensor  # (N,) in {0, 1}
    smoothing_std: torch.Tensor  # (N,) >= 0
    gh_nodes: torch.Tensor  # (Q,) Hermite nodes (physicists' convention)
    gh_weights: torch.Tensor  # (Q,) Hermite weights
    link_function: PLSLinkFunction = SigmoidLinkFunction()
    observation_noise: None = None
    # "hermgauss" when the factory built the rule from numpy's hermgauss;
    # kept for parity with the JAX package (eligibility for the general
    # kernel checks the arrays themselves)
    gh_rule: str = "custom"

    def __post_init__(self):
        if not isinstance(self.link_function, SigmoidLinkFunction):
            raise NotImplementedError("SmoothedBernoulliCost implements the sigmoid link only")

    def replace(self, **changes) -> SmoothedBernoulliCost:
        return dataclasses.replace(self, **changes)

    def predict(self, prediction_samples: torch.Tensor) -> Bernoulli:
        return Bernoulli(probs=torch.mean(prediction_samples, dim=1))

    def _expected(self, f: torch.Tensor, fn) -> torch.Tensor:
        """E_z[fn(F + s z)] by Gauss-Hermite, accumulated node by node so
        that only (N, J) buffers are live, never an (N, J, Q) one."""
        scale = math.sqrt(2.0) * self.smoothing_std[:, None]
        acc = torch.zeros_like(f)
        for q in range(self.gh_nodes.shape[0]):
            acc = acc + self.gh_weights[q] * fn(f + scale * self.gh_nodes[q])
        return acc / math.sqrt(math.pi)

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        f = untransformed_train_prediction_samples
        return torch.sum(self._expected(f, softplus) - self.y_train[:, None] * f, dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        if force_autograd:
            return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
        f = untransformed_train_prediction_samples
        return self._expected(f, torch.sigmoid) - self.y_train[:, None]


def make_smoothed_bernoulli_cost(
    y_train,
    smoothing_std,
    number_of_quadrature_nodes: int = 16,
    link_function: PLSLinkFunction | None = None,
    device=None,
) -> SmoothedBernoulliCost:
    """A :class:`SmoothedBernoulliCost` (sigmoid link only) with numpy's
    ``hermgauss`` rule.

    Labels that are not a float of at least 32 bits (integer {0, 1}, bf16,
    fp16) are promoted to the default float dtype: the rule is cast to the
    labels' dtype, and an integer or 16-bit dtype would truncate the
    2.6e-10 .. 0.5 Hermite weights."""
    if link_function is None:
        link_function = SigmoidLinkFunction()
    if not isinstance(link_function, SigmoidLinkFunction):
        raise NotImplementedError(
            "SmoothedBernoulliCost implements the sigmoid link only "
            "(the softplus/sigmoid quadrature identities are sigmoid-specific)"
        )
    nodes, weights = np.polynomial.hermite.hermgauss(number_of_quadrature_nodes)
    y_train = as_tensor(y_train, device=device)
    if y_train.is_floating_point() and torch.finfo(y_train.dtype).bits >= 32:
        dtype = y_train.dtype
    else:
        dtype = torch.get_default_dtype()
    device = y_train.device
    return SmoothedBernoulliCost(
        y_train=y_train.to(dtype),
        smoothing_std=as_tensor(smoothing_std, device=device, dtype=dtype),
        gh_nodes=torch.as_tensor(nodes, dtype=dtype, device=device),
        gh_weights=torch.as_tensor(weights, dtype=dtype, device=device),
        link_function=link_function,
        gh_rule="hermgauss",
    )


def residual_smoothing_std(basis, train_kernel_diag) -> torch.Tensor:
    """Per-train-point residual std ``sqrt(k_ii - Q_ii)`` of an ONB basis
    built with ``scaling="nystrom"``, where ``B Lambda B^T`` is the Nystrom
    ``Qff``; under the reference scaling it has no such meaning, so this
    raises."""
    if getattr(basis, "scaling", None) != "nystrom":
        raise ValueError(
            "residual_smoothing_std requires an OrthonormalBasis built with "
            f'scaling="nystrom" (got {getattr(basis, "scaling", None)!r})'
        )
    q_diag = torch.sum(torch.square(basis.train_projection) * basis.eigenvalues[None, :], dim=1)
    k_diag = as_tensor(train_kernel_diag, device=q_diag.device)
    return torch.sqrt(torch.clamp_min(k_diag - q_diag, 0.0))
