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

The two methods are plain PyTorch, node by node (the MAP mean constant
differentiates them with ``torch.func``). ``calculate_cost_and_derivative``,
which the ``off`` tier's step calls, runs both in one pass of the kernel
``ops/cuda/smoothed_bernoulli.py`` for every CUDA F, in the dtype the two
methods would give (F and the rule cast to it; the kernel takes float32 and
float64 and raises on others), and the two methods for a CPU F.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.distributions import Bernoulli
from projected_langevin_sampling_torch.models.link_functions import (
    PLSLinkFunction,
    SigmoidLinkFunction,
)
from projected_langevin_sampling_torch.ops.cuda.cost_forms import softplus
from projected_langevin_sampling_torch.ops.cuda.smoothed_bernoulli import (
    gauss_hermite_mean,
    smoothed_bernoulli,
)
from projected_langevin_sampling_torch.utils.device import as_tensor


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

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        f = untransformed_train_prediction_samples
        rule = (self.smoothing_std, self.gh_nodes, self.gh_weights)
        return torch.sum(gauss_hermite_mean(f, *rule, softplus) - self.y_train[:, None] * f, dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        if force_autograd:
            return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
        f = untransformed_train_prediction_samples
        rule = (self.smoothing_std, self.gh_nodes, self.gh_weights)
        return gauss_hermite_mean(f, *rule, torch.sigmoid) - self.y_train[:, None]

    def calculate_cost_and_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(cost (J,), dc (N, J)): one kernel pass on a CUDA F, the two
        methods on a CPU F. The kernel computes in the dtype the two methods'
        type promotion gives (fp64 F with fp32 labels: fp64)."""
        f = untransformed_train_prediction_samples
        if f.device.type != "cuda":
            return super().calculate_cost_and_derivative(f)
        rule = (self.y_train, self.smoothing_std, self.gh_nodes, self.gh_weights)
        dtype = functools.reduce(torch.promote_types, (t.dtype for t in rule), f.dtype)
        return smoothed_bernoulli(f.to(dtype).contiguous(),
                                  *(t.to(dtype).contiguous() for t in rule))


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
