"""Sparse variational GP (SVGP) baseline (counterpart of
``projected_langevin_sampling_tpu/models/gaussian_process/svgp.py``;
reference ``src/gaussian_process/svgp.py:6-49`` over gpytorch's
CholeskyVariationalDistribution and VariationalStrategy).

Whitened parameterisation (gpytorch's default): q(u) = N(L v, L S L^T) with
S = C C^T and L = chol(K_zz), so the KL term is against N(0, I) and the ELBO
is a handful of matrix products. The kernel is an ``ARDKernel`` or a
``PLSKernel`` (the curve mains build the SVGP on the r-kernel). K_zz is the
same-input gram ``kernel(z)`` for an ARD kernel (the JAX package's
``kernel(z, z)``), whose diagonal distance is exactly 0.
"""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.distributions import MultivariateNormal
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, _as_2d
from projected_langevin_sampling_torch.ops.linalg import psd_safe_cholesky
from projected_langevin_sampling_torch.utils.device import as_tensor


def same_input_gram(kernel, x: torch.Tensor) -> torch.Tensor:
    """k(x, x): the ARD kernel's same-input gram (``x2=None``), or the PLS
    kernel's r(x, x)."""
    return kernel(x) if isinstance(kernel, ARDKernel) else kernel(x, x)


@dataclasses.dataclass(frozen=True)
class Projection:
    """The kernel side of q(f) at N inputs (:meth:`SVGP.project`): A = K_xz
    L^{-T} (N, M) and the prior variance k(x, x) (N,). Each row is a function
    of its own input alone, so a projection indexes like its inputs: its rows
    are the projection of those inputs' rows."""

    a: torch.Tensor
    k_diag: torch.Tensor

    def __len__(self) -> int:
        return self.a.shape[0]

    def __getitem__(self, index) -> Projection:
        return Projection(self.a[index], self.k_diag[index])


@dataclasses.dataclass(frozen=True)
class SVGP:
    mean_constant: torch.Tensor  # scalar
    kernel: object  # ARDKernel or PLSKernel
    likelihood: object  # GaussianLikelihood, BernoulliLikelihood or StudentTLikelihood
    x_induce: torch.Tensor  # (M, D)
    variational_mean: torch.Tensor  # v, (M,), whitened
    variational_chol: torch.Tensor  # C (lower), (M, M), whitened, S = C C^T
    jitter: float = 1e-8

    def replace(self, **changes) -> SVGP:
        return dataclasses.replace(self, **changes)

    @property
    def num_inducing(self) -> int:
        return self.x_induce.shape[0]

    @property
    def _chol_s(self) -> torch.Tensor:
        """The lower triangle of the raw variational factor: gradient steps
        fill the whole matrix, and only its lower triangle is the parameter
        (as gpytorch's CholeskyVariationalDistribution)."""
        return torch.tril(self.variational_chol)

    def _effective_jitter(self, dtype) -> float:
        """gpytorch's psd_safe_cholesky floors, 1e-6 in fp32 and 1e-8 in fp64:
        the PLS r-kernel squares the base kernel's spectrum, so K_zz has
        eigenvalues below fp32 resolution and an unfloored 1e-8 jitter gives
        a garbage factor (the ELBO explodes within a few steps)."""
        floor = 1e-6 if dtype == torch.float32 else 1e-8
        return max(self.jitter, floor)

    def _chol_kzz(self) -> torch.Tensor:
        k_zz = same_input_gram(self.kernel, self.x_induce)
        return psd_safe_cholesky(k_zz, self._effective_jitter(k_zz.dtype))

    def project(self, x: torch.Tensor) -> Projection:
        """The kernel side of q(f(x)), which no variational parameter
        reaches: A = K_xz L^{-T} and k(x, x)."""
        x = _as_2d(x)
        chol = self._chol_kzz()
        k_xz = self.kernel(x, self.x_induce)  # (N, M)
        a = torch.linalg.solve_triangular(chol, k_xz.T, upper=False).T  # (N, M)
        return Projection(a, self.kernel(x, x, diag=True))

    def latent(self, x: torch.Tensor | Projection) -> MultivariateNormal:
        """q(f(x)) marginals: mean = m0 + A v, var = k_xx - rowsum(A^2) +
        rowsum((A C)^2), from the inputs or their :class:`Projection`."""
        p = x if isinstance(x, Projection) else self.project(x)
        mean = self.mean_constant + p.a @ self.variational_mean
        ac = p.a @ self._chol_s
        var = p.k_diag - torch.sum(torch.square(p.a), dim=1) + torch.sum(torch.square(ac), dim=1)
        return MultivariateNormal(mean=mean, variance=torch.clamp_min(var, 0.0))

    def kl_divergence(self) -> torch.Tensor:
        """KL(q(u) || p(u)) in whitened coordinates, against N(0, I)."""
        c = self._chol_s
        m = self.variational_mean
        trace = torch.sum(torch.square(c))
        logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(c))))
        return 0.5 * (trace + m @ m - m.shape[0] - logdet)

    def elbo(self, x_batch: torch.Tensor | Projection, y_batch: torch.Tensor,
             num_data: int) -> torch.Tensor:
        """Minibatch ELBO (gpytorch's VariationalELBO times N):
        (N / B) sum_batch E_q[log p(y|f)] - KL, on the batch's inputs or
        their :class:`Projection`."""
        q_f = self.latent(x_batch)
        ell = self.likelihood.expected_log_prob(y_batch, q_f.mean, q_f.variance)
        return (num_data / len(x_batch)) * torch.sum(ell) - self.kl_divergence()

    def predict_y(self, x: torch.Tensor):
        """The likelihood's marginal of q(f) (the reference's
        ``gp.likelihood(gp(x))``)."""
        q_f = self.latent(x)
        return self.likelihood.marginal(q_f.mean, q_f.variance)

    def __call__(self, x: torch.Tensor) -> MultivariateNormal:
        return self.latent(x)


def init_svgp(mean_constant, kernel, likelihood, x_induce, jitter: float = 1e-8) -> SVGP:
    """A fresh SVGP with q(u) = N(0, I) in whitened coordinates (gpytorch's
    CholeskyVariationalDistribution initialisation), on the inducing inputs'
    device (a tensor's own, else the card unless the caller asks for the
    CPU)."""
    x_induce = _as_2d(as_tensor(x_induce))
    m, dtype, device = x_induce.shape[0], x_induce.dtype, x_induce.device
    return SVGP(
        mean_constant=torch.as_tensor(mean_constant, dtype=dtype, device=device),
        kernel=kernel,
        likelihood=likelihood,
        x_induce=x_induce,
        variational_mean=torch.zeros(m, dtype=dtype, device=device),
        variational_chol=torch.eye(m, dtype=dtype, device=device),
        jitter=jitter,
    )


def titsias_optimal_svgp(svgp: SVGP, x_train: torch.Tensor, y_train: torch.Tensor) -> SVGP:
    """The closed-form optimal q(u) for the Gaussian likelihood (Titsias 2009):

        Sigma = (K_zz + K_zx K_xz / sigma^2)^{-1}
        m_u   = K_zz Sigma K_zx (y - m0) / sigma^2
        S_u   = K_zz Sigma K_zz

    in whitened coordinates: v = L^{-1} m_u, C = L^{-1} chol(S_u)."""
    x_train = _as_2d(x_train)
    sigma2 = svgp.likelihood.noise
    k_zz = same_input_gram(svgp.kernel, svgp.x_induce)
    k_zx = svgp.kernel(svgp.x_induce, x_train)
    jit = svgp._effective_jitter(k_zz.dtype)
    chol_a = psd_safe_cholesky(k_zz + (k_zx @ k_zx.T) / sigma2, jit)
    resid = y_train - svgp.mean_constant
    sigma_kzx_y = torch.cholesky_solve((k_zx @ resid)[:, None], chol_a)[:, 0] / sigma2
    m_u = k_zz @ sigma_kzx_y
    s_u = k_zz @ torch.cholesky_solve(k_zz, chol_a)

    chol_kzz = svgp._chol_kzz()
    v_mean = torch.linalg.solve_triangular(chol_kzz, m_u[:, None], upper=False)[:, 0]
    chol_s = psd_safe_cholesky(0.5 * (s_u + s_u.T), jit)
    c = torch.linalg.solve_triangular(chol_kzz, chol_s, upper=False)
    return svgp.replace(variational_mean=v_mean, variational_chol=c)
