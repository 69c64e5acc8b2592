"""Exact GP baseline (counterpart of
``projected_langevin_sampling_tpu/models/gaussian_process/exact_gp.py``;
reference ``src/gaussian_process/exact_gp.py:5-30`` plus gpytorch's
ExactMarginalLogLikelihood, ``experiments/trainers.py:15-52``).

A frozen dataclass of tensors: constant mean, ARD kernel, noise. The marginal
log-likelihood is one Cholesky factorisation; ``fit_exact_gp`` (``training.py``)
differentiates it through the gram, which on the card is B2 with its
backward. The training gram is the same-input gram ``kernel(x)``, whose
diagonal distance is exactly 0 (the JAX package's ``kernel(x, x)``), so
duplicate rows cannot make ``K + sigma^2 I`` indefinite.

Every factorisation of ``K + sigma^2 I`` goes through
``nan_rescued_cholesky``: the plain factor where it is finite, escalating
jitter where it is not, as gpytorch's psd_safe_cholesky retries.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from projected_langevin_sampling_torch.models.distributions import MultivariateNormal
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, _as_2d
from projected_langevin_sampling_torch.ops.linalg import nan_rescued_cholesky


@dataclasses.dataclass(frozen=True)
class ExactGP:
    """Constant-mean exact GP with an ARD kernel and Gaussian noise."""

    mean_constant: torch.Tensor  # scalar
    kernel: ARDKernel
    noise: torch.Tensor  # noise variance (scalar; the learned part)
    x_train: torch.Tensor  # (N, D)
    y_train: torch.Tensor  # (N,)
    # optional fixed per-point noise variances (N,) added to ``noise`` (the
    # Dirichlet classification case, gpytorch's FixedNoiseGaussianLikelihood)
    fixed_noise_variances: torch.Tensor | None = None

    def replace(self, **changes) -> ExactGP:
        return dataclasses.replace(self, **changes)

    @property
    def likelihood_noise(self) -> torch.Tensor:
        return self.noise

    def _noise_diag(self) -> torch.Tensor:
        diag = self.noise * torch.ones_like(self.y_train)
        if self.fixed_noise_variances is not None:
            diag = diag + self.fixed_noise_variances
        return diag

    def prior(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Latent prior mean vector and covariance at x (reference
        ``exact_gp.py:27-30``); the covariance is the same-input gram."""
        x = _as_2d(x)
        mean = self.mean_constant * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        return mean, self.kernel(x)

    def _train_factor(self, factor=nan_rescued_cholesky) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean at x_train, Cholesky factor of K + noise)."""
        mean, k = self.prior(self.x_train)
        return mean, factor(k + torch.diag(self._noise_diag()))

    def log_marginal_likelihood(self, factor=nan_rescued_cholesky) -> torch.Tensor:
        """log p(y | X), the exact MLL (gpytorch's ExactMarginalLogLikelihood
        times N). ``factor`` computes the Cholesky factor of K + noise; the
        graphed fit passes one that reads nothing on the host."""
        n = self.y_train.shape[0]
        mean, chol = self._train_factor(factor)
        resid = (self.y_train - mean)[:, None]
        alpha = torch.cholesky_solve(resid, chol)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return -0.5 * (torch.sum(resid * alpha) + logdet + n * math.log(2.0 * math.pi))

    def predict_f(self, x: torch.Tensor) -> MultivariateNormal:
        """Latent posterior p(f* | y) with diagonal covariance."""
        x = _as_2d(x)
        mean_train, chol = self._train_factor()
        k_cross = self.kernel(x, self.x_train)  # (N*, N)
        alpha = torch.cholesky_solve((self.y_train - mean_train)[:, None], chol)[:, 0]
        mean = self.mean_constant + k_cross @ alpha
        v = torch.linalg.solve_triangular(chol, k_cross.T, upper=False)  # (N, N*)
        var = self.kernel(x, x, diag=True) - torch.sum(torch.square(v), dim=0)
        return MultivariateNormal(mean=mean, variance=torch.clamp_min(var, 0.0))

    def predict_y(self, x: torch.Tensor) -> MultivariateNormal:
        """Predictive over observations: latent posterior plus the learned
        noise (the reference's ``gp.likelihood(gp(x))``)."""
        latent = self.predict_f(x)
        return MultivariateNormal(mean=latent.mean, variance=latent.variance + self.noise)

    def __call__(self, x: torch.Tensor) -> MultivariateNormal:
        return self.predict_f(x)
