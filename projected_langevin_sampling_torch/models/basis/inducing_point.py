"""Inducing-point (non-orthonormal) basis (counterpart of
``projected_langevin_sampling_tpu/models/basis/inducing_point.py``; reference
``basis/inducing_point.py:11-240``).

Build time (once):
  * grams r(Z,Z), k(Z,Z), k(Z,X), every one through ``ops/kernels.py`` (the
    gram kernel on the card);
  * the Cholesky factor of k(Z,Z) (host escalating jitter), then the explicit
    inverse K^{-1} and the train projection P = k(X,Z) K^{-1} (N, M), where
    the reference solves every step;
  * the PSD square root S of k(Z,Z) in host fp64, for the update noise S z.

Training: F = m0 + P U and
dU = -eta k(Z,X) dc - eta M K^{-1} U + sqrt(2 eta) S z.
Prediction: Matheron pathwise conditioning; a leading batch dimension on
``x`` stands for the JAX package's ``vmap`` over prediction chunks and takes
its traced route, an eigh with an eigenvalue floor in place of the host
Cholesky.
"""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.basis.base import PLSBasisMixin
from projected_langevin_sampling_torch.ops.kernels import (
    PLSKernel,
    _as_2d,
    ard_gram,
    augment_approximation_samples,
)
from projected_langevin_sampling_torch.ops.linalg import (
    cholesky_solve,
    psd_sqrt,
    psd_sqrt_host,
    robust_cholesky,
    sample_with_factor,
)
from projected_langevin_sampling_torch.utils.device import as_tensor
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


@dataclasses.dataclass(frozen=True)
class InducingPointBasis(PLSBasisMixin):
    kernel: PLSKernel
    x_induce: torch.Tensor  # (M, D)
    y_induce: torch.Tensor  # (M,)
    gram_induce: torch.Tensor  # r(Z, Z), (M, M)
    base_gram_induce: torch.Tensor  # k(Z, Z), (M, M)
    base_gram_induce_train: torch.Tensor  # k(Z, X), (M, N)
    inv_base_gram_induce: torch.Tensor  # k(Z, Z)^{-1}, (M, M)
    train_projection: torch.Tensor  # k(X, Z) k(Z, Z)^{-1}, (N, M)
    noise_factor: torch.Tensor  # S with S S^T = k(Z, Z), (M, M)
    # extra noise on the whole predictive noise (noise_distributions.py)
    additional_predictive_noise_distribution: object | None = None
    # prior mean constant m0: f(x) = m0 + ... (0 in the reference)
    mean_constant: float = 0.0

    def replace(self, **changes) -> InducingPointBasis:
        return dataclasses.replace(self, **changes)

    @property
    def approximation_dimension(self) -> int:
        """M, the number of inducing points."""
        return self.x_induce.shape[0]

    @property
    def dtype(self):
        return self.base_gram_induce.dtype

    @property
    def device(self):
        return self.base_gram_induce.device

    # --- particle initialisation -------------------------------------------
    def _initialise_particles(
        self, number_of_particles: int, noise_only: bool = True, generator: GeneratorLike = None
    ) -> torch.Tensor:
        """Noise, optionally recentred on y(Z) - m0 (particles are the centred
        latent values; reference ``inducing_point.py:60-79``)."""
        noise = self._initialise_particles_noise(number_of_particles, generator=generator)
        if noise_only:
            return noise
        return (self.y_induce - self.mean_constant)[:, None] + noise

    # --- training -------------------------------------------------------------
    def calculate_untransformed_train_prediction_samples(self, particles: torch.Tensor) -> torch.Tensor:
        """F = m0 + P @ U, (N, J)."""
        pred = self.train_projection @ particles
        if self.mean_constant != 0.0:
            pred = pred + self.mean_constant
        return pred

    def calculate_particle_energies(self, particles: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        """(J,) cost_j + M/2 ||K^{-1} U_j||^2."""
        kinv_u = self.inv_base_gram_induce @ particles
        prior = 0.5 * self.approximation_dimension * torch.sum(torch.square(kinv_u), dim=0)
        return cost + prior

    def calculate_energy_potential(self, particles: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        """mean_j [cost_j + M/2 ||K^{-1} U_j||^2]."""
        return torch.mean(self.calculate_particle_energies(particles, cost))

    def sample_update_noise(
        self, number_of_particles: int, generator: torch.Generator | None = None,
        normals: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """e = S z ~ N(0, k(Z,Z)); ``normals`` injects z."""
        return sample_with_factor(self.noise_factor, number_of_particles, generator=generator,
                                  normals=normals)

    def _calculate_particle_update(
        self, particles: torch.Tensor, cost_derivative: torch.Tensor, step_size: float,
        noise: torch.Tensor,
    ) -> torch.Tensor:
        """-eta k(Z,X) dc - eta M K^{-1} U + sqrt(2 eta) e."""
        drift_data = self.base_gram_induce_train @ cost_derivative
        drift_prior = self.approximation_dimension * (self.inv_base_gram_induce @ particles)
        return (
            -step_size * drift_data
            - step_size * drift_prior
            + (2.0 * step_size) ** 0.5 * noise
        )

    # --- prediction -------------------------------------------------------------
    def _approximation_samples(self, flat_x: torch.Tensor, augmentation_samples):
        """The PLS kernel's samples augmented by ``augmentation_samples`` (by
        ``flat_x`` when None; a zero-row set means augmented already)."""
        aug = flat_x if augmentation_samples is None else augmentation_samples
        samples = self.kernel.approximation_samples
        if aug.shape[0] > 0:
            samples = augment_approximation_samples(samples, aug)
        return samples

    def predictive_noise_covariance(
        self, x: torch.Tensor, augmentation_samples: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Covariance of G([Z, x]), [[r(Z,Z), r(Z,x)], [r(x,Z), r(x,x)]], with
        the stored, unaugmented r(Z,Z) in the top-left block and the cross and
        test blocks over the augmented samples (reference
        ``inducing_point.py:152-202``); x (c, D) -> (M + c, M + c) or
        (B, c, D) -> batched."""
        batched = x.ndim == 3
        x3 = x if batched else _as_2d(x)[None]
        flat_x = x3.reshape(-1, x3.shape[-1])
        samples = self._approximation_samples(flat_x, augmentation_samples)
        base = self.kernel.base_kernel
        k_xs = ard_gram(base, flat_x, samples).reshape(*x3.shape[:-1], samples.shape[0])
        k_zs = ard_gram(base, self.x_induce, samples)
        gram_induce_x = (k_zs @ k_xs.transpose(-1, -2)) / samples.shape[0]  # (B, M, c)
        gram_x = (k_xs @ k_xs.transpose(-1, -2)) / samples.shape[0]  # (B, c, c)
        top_left = self.gram_induce.expand(x3.shape[0], -1, -1)
        cov = torch.cat(
            [torch.cat([top_left, gram_induce_x], dim=-1),
             torch.cat([gram_induce_x.transpose(-1, -2), gram_x], dim=-1)],
            dim=-2,
        )
        return cov if batched else cov[0]

    def sample_predictive_noise(
        self,
        particles: torch.Tensor,
        x: torch.Tensor,
        generator: GeneratorLike = None,
        augmentation_samples: torch.Tensor | None = None,
        normals: torch.Tensor | None = None,
        extra: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Joint MVN draw (..., M + c, J) of G([Z, x]), plus the extra
        predictive noise where the basis has one; ``normals`` injects the
        standard normals and ``extra`` the extra noise."""
        cov = self.predictive_noise_covariance(x, augmentation_samples)
        if normals is None:
            generator = as_generator(generator, device=self.device)
        noise = sample_with_factor(
            psd_sqrt(cov), particles.shape[1], generator=generator, normals=normals
        )
        return self._with_additional_predictive_noise(noise, generator, extra)

    def predict_untransformed_samples(
        self,
        particles: torch.Tensor,
        x: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
        augmentation_samples: torch.Tensor | None = None,
        normals: torch.Tensor | None = None,
        extra: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """G(x) + r(x,Z) r_aug(Z,Z)^{-1} (U - G(Z)) (reference
        ``inducing_point.py:204-240``), with the augmented r(Z,Z) in the solve.

        x (c, D): the solve factors r_aug(Z,Z) on the host with escalating
        jitter (:func:`robust_cholesky`). x (B, c, D), the chunked predict:
        the JAX package's traced route, an eigh with the eigenvalues floored at
        eps max|w| (``inducing_point.py:180-189``); every block shares r_aug(Z,Z),
        so it is factored once. The noise is ``noise``, else drawn with
        ``normals`` and ``extra`` injected where given
        (:meth:`sample_predictive_noise`)."""
        x = x if x.ndim == 3 else _as_2d(x)
        flat_x = x.reshape(-1, x.shape[-1])
        samples = self._approximation_samples(flat_x, augmentation_samples)
        base = self.kernel.base_kernel
        k_zs = ard_gram(base, self.x_induce, samples)
        k_xs = ard_gram(base, flat_x, samples).reshape(*x.shape[:-1], samples.shape[0])
        gram_x_induce = (k_xs @ k_zs.T) / samples.shape[0]  # (..., c, M)
        gram_induce_aug = (k_zs @ k_zs.T) / samples.shape[0]  # (M, M)
        if noise is None:
            noise = self.sample_predictive_noise(
                particles, x, generator=generator, augmentation_samples=augmentation_samples,
                normals=normals, extra=extra,
            )
        m = self.approximation_dimension
        rhs = particles - noise[..., :m, :]
        if x.ndim == 3:
            w, v = torch.linalg.eigh(gram_induce_aug)
            w = torch.clamp_min(w, torch.finfo(w.dtype).eps * torch.max(torch.abs(w)))
            solved = v @ ((v.T @ rhs) / w[:, None])
        else:
            chol, _ = robust_cholesky(gram_induce_aug)
            solved = cholesky_solve(chol, rhs)
        out = noise[..., m:, :] + gram_x_induce @ solved
        if self.mean_constant != 0.0:
            out = out + self.mean_constant
        return out


def build_inducing_point_basis(
    kernel: PLSKernel,
    x_induce,
    y_induce,
    x_train,
    additional_predictive_noise_distribution: object | None = None,
    mean_constant: float = 0.0,
) -> InducingPointBasis:
    """Build the basis on the kernel's device (reference
    ``inducing_point.py:23-50`` plus the factorisations the reference defers
    to the hot loop)."""
    device = kernel.base_kernel.device
    x_induce = _as_2d(as_tensor(x_induce, device=device))
    x_train = _as_2d(as_tensor(x_train, device=device))
    y_induce = as_tensor(y_induce, device=device)

    gram_induce = kernel.forward(x_induce, x_induce)  # r(Z, Z)
    base_gram_induce = ard_gram(kernel.base_kernel, x_induce)  # k(Z, Z), same input
    base_gram_induce_train = ard_gram(kernel.base_kernel, x_induce, x_train)  # k(Z, X)

    chol, _ = robust_cholesky(base_gram_induce)
    eye = torch.eye(base_gram_induce.shape[0], dtype=base_gram_induce.dtype, device=device)
    return InducingPointBasis(
        kernel=kernel,
        x_induce=x_induce,
        y_induce=y_induce,
        gram_induce=gram_induce,
        base_gram_induce=base_gram_induce,
        base_gram_induce_train=base_gram_induce_train,
        inv_base_gram_induce=cholesky_solve(chol, eye),
        train_projection=cholesky_solve(chol, base_gram_induce_train).T.contiguous(),
        noise_factor=psd_sqrt_host(base_gram_induce),
        additional_predictive_noise_distribution=additional_predictive_noise_distribution,
        mean_constant=float(mean_constant),
    )
