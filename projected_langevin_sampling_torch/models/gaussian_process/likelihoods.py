"""GP likelihoods for the baseline models (counterpart of
``projected_langevin_sampling_tpu/models/gaussian_process/likelihoods.py``;
the reference uses gpytorch's GaussianLikelihood, BernoulliLikelihood and
StudentTLikelihood, ``experiments/trainers.py``).

Each likelihood is a frozen dataclass providing

  * ``expected_log_prob(y, mean_f, var_f)``: E_{f~N(mean_f, var_f)}[log p(y|f)]
    for the SVGP ELBO (closed form for the Gaussian; 20-node Gauss-Hermite
    quadrature for the Bernoulli and the Student-T);
  * ``marginal(mean_f, var_f)``: the predictive distribution over y.

Scalar parameters are raw positive tensors; the trainers fit their logs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from projected_langevin_sampling_torch.models.distributions import (
    Bernoulli,
    MultivariateNormal,
    StudentTMarginals,
    student_t_log_normalizer,
)

_GH_POINTS = 20


_GH_RULES: dict = {}


def _gh_rule(dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The quadrature's nodes and normalised weights on ``device``, copied
    there once: a copy from the host cannot be captured in a CUDA graph."""
    key = (dtype, device)
    if key not in _GH_RULES:
        nodes, weights = np.polynomial.hermite.hermgauss(_GH_POINTS)
        _GH_RULES[key] = (torch.as_tensor(nodes, dtype=dtype, device=device),
                          torch.as_tensor(weights / np.sqrt(np.pi), dtype=dtype, device=device))
    return _GH_RULES[key]


def _gauss_hermite(mean_f: torch.Tensor, var_f: torch.Tensor, log_prob_fn) -> torch.Tensor:
    """E_{f ~ N(mean_f, var_f)}[log_prob_fn(f)] per data point, by
    Gauss-Hermite quadrature (physicists' nodes)."""
    nodes, weights = _gh_rule(mean_f.dtype, mean_f.device)
    f = mean_f[:, None] + torch.sqrt(2.0 * var_f)[:, None] * nodes[None, :]  # (N, Q)
    return torch.sum(log_prob_fn(f) * weights[None, :], dim=1)


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood:
    noise: torch.Tensor  # noise variance sigma^2 (scalar)

    def replace(self, **changes) -> GaussianLikelihood:
        return dataclasses.replace(self, **changes)

    def expected_log_prob(self, y, mean_f, var_f) -> torch.Tensor:
        """Closed form: log N(y | mean_f, noise) - var_f / (2 noise)."""
        return (
            -0.5 * torch.log(2.0 * math.pi * self.noise)
            - 0.5 * torch.square(y - mean_f) / self.noise
            - 0.5 * var_f / self.noise
        )

    def marginal(self, mean_f, var_f) -> MultivariateNormal:
        return MultivariateNormal(mean=mean_f, variance=var_f + self.noise)

    def log_prob(self, y, f) -> torch.Tensor:
        return -0.5 * (torch.log(2.0 * math.pi * self.noise) + torch.square(y - f) / self.noise)


@dataclasses.dataclass(frozen=True)
class BernoulliLikelihood:
    """Probit Bernoulli likelihood (gpytorch's BernoulliLikelihood)."""

    def replace(self, **changes) -> BernoulliLikelihood:
        return dataclasses.replace(self, **changes)

    def log_prob(self, y, f) -> torch.Tensor:
        # y in {0, 1}: log Phi(f)^y (1 - Phi(f))^(1-y) = log Phi((2y - 1) f)
        z = (2.0 * y - 1.0)[:, None] if f.ndim == 2 else (2.0 * y - 1.0)
        return torch.special.log_ndtr(z * f)

    def expected_log_prob(self, y, mean_f, var_f) -> torch.Tensor:
        return _gauss_hermite(mean_f, var_f, lambda f: self.log_prob(y, f))

    def marginal(self, mean_f, var_f) -> Bernoulli:
        """p(y=1) = Phi(mean / sqrt(1 + var)), the exact probit integral."""
        return Bernoulli(probs=torch.special.ndtr(mean_f / torch.sqrt(1.0 + var_f)))


@dataclasses.dataclass(frozen=True)
class StudentTLikelihood:
    noise: torch.Tensor  # scale^2 analogue (scalar), fitted in log-space
    degrees_of_freedom: float = 4.0

    def replace(self, **changes) -> StudentTLikelihood:
        return dataclasses.replace(self, **changes)

    def log_prob(self, y, f) -> torch.Tensor:
        df = float(self.degrees_of_freedom)
        scale = torch.sqrt(self.noise)
        yy = y[:, None] if f.ndim == 2 and y.ndim == 1 else y
        z = (yy - f) / scale
        # the normaliser in host fp64: the lgamma difference cancels in fp32
        # for the large df a t fit returns
        return (
            student_t_log_normalizer(df)
            - torch.log(scale)
            - ((df + 1.0) / 2.0) * torch.log1p(torch.square(z) / df)
        )

    def expected_log_prob(self, y, mean_f, var_f) -> torch.Tensor:
        return _gauss_hermite(mean_f, var_f, lambda f: self.log_prob(y, f))

    def marginal(self, mean_f, var_f) -> StudentTMarginals:
        """Student-T marginals on the latent mean, with the latent variance
        folded in by moment matching: s^2 = noise + var_f (df - 2)/df (noise +
        var_f for df <= 2). PARITY.md documents the departure from the
        reference's sampled marginals."""
        df = float(self.degrees_of_freedom)
        latent_factor = (df - 2.0) / df if df > 2.0 else 1.0
        return StudentTMarginals(
            df=df, loc=mean_f, scale=torch.sqrt(self.noise + var_f * latent_factor)
        )
