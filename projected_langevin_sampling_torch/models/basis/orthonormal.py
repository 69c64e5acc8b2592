"""Orthonormal (KKL eigen-) basis (counterpart of
``projected_langevin_sampling_tpu/models/basis/orthonormal.py``; reference
``basis/orthonormal.py:10-244``).

Build time (once, host fp64 for the O(M^3) step):
  * eigh((1/M) k(Z,Z)); eigenpairs at or below the threshold are dropped;
  * scaled eigenvectors  Vt = V / sqrt(M_k * lambda)   (M, M_k)
  * train projection     B  = k(Z,X)^T @ Vt            (N, M_k), in fp64

Training: F = B @ U and dU = -eta B^T dc(F) - eta U / lambda + sqrt(2 eta) eps.
Prediction: Matheron pathwise conditioning with the Z-union-x augmentation;
a leading batch dimension on ``x`` stands for the JAX package's ``vmap`` over
prediction chunks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from projected_langevin_sampling_torch.models.basis.base import PLSBasisMixin
from projected_langevin_sampling_torch.ops.kernels import (
    PLSKernel,
    _as_2d,
    ard_gram,
    augment_approximation_samples,
)
from projected_langevin_sampling_torch.ops.linalg import psd_sqrt, sample_with_factor
from projected_langevin_sampling_torch.utils.device import as_tensor
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


@dataclasses.dataclass(frozen=True)
class OrthonormalBasis(PLSBasisMixin):
    kernel: PLSKernel
    x_induce: torch.Tensor  # (M, D)
    eigenvalues: torch.Tensor  # (M_k,)
    scaled_eigenvectors: torch.Tensor  # (M, M_k)
    base_gram_induce_train: torch.Tensor  # k(Z, X), (M, N)
    train_projection: torch.Tensor  # B = k(Z,X)^T @ Vt, (N, M_k)
    # extra noise on the whole predictive noise (noise_distributions.py)
    additional_predictive_noise_distribution: object | None = None
    # "reference": Vt = V / sqrt(M_k lambda), the reference's formula.
    # "nystrom": Vt = V / (sqrt(M) lambda), so Vt Lambda Vt^T == Kzz^{-1}
    # (truncated) and the implied prior is the Nystrom approximation of k.
    scaling: str = "reference"
    # prior mean constant m0: f(x) = m0 + sum_i phi_i(x) U_i (0 in the reference)
    mean_constant: float = 0.0

    def replace(self, **changes) -> OrthonormalBasis:
        return dataclasses.replace(self, **changes)

    @property
    def approximation_dimension(self) -> int:
        """M_k, the number of kept eigenpairs."""
        return self.eigenvalues.shape[0]

    @property
    def dtype(self):
        return self.eigenvalues.dtype

    @property
    def device(self):
        return self.eigenvalues.device

    @property
    def eigenvectors(self) -> torch.Tensor:
        """Unscaled eigenvectors V, inverting whichever scaling built Vt."""
        if self.scaling == "nystrom":
            scale = math.sqrt(self.x_induce.shape[0]) * self.eigenvalues
        else:
            scale = torch.sqrt(self.approximation_dimension * self.eigenvalues)
        return self.scaled_eigenvectors * scale[None, :]

    # --- particle initialisation -------------------------------------------
    def _initialise_particles(
        self, number_of_particles: int, noise_only: bool = True, generator: GeneratorLike = None
    ) -> torch.Tensor:
        if not noise_only:
            raise ValueError("For ONB base, noise_only must be True.")
        return self._initialise_particles_noise(number_of_particles, generator=generator)

    # --- training -------------------------------------------------------------
    def calculate_untransformed_train_prediction_samples(self, particles: torch.Tensor) -> torch.Tensor:
        """F = m0 + B @ U, (N, J)."""
        pred = self.train_projection @ particles
        if self.mean_constant != 0.0:
            pred = pred + self.mean_constant
        return pred

    def calculate_particle_energies(self, particles: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        """(J,) cost_j + 1/2 U_j^T Lambda^{-1} U_j."""
        prior = 0.5 * torch.sum(torch.square(particles) / self.eigenvalues[:, None], dim=0)
        return cost + prior

    def calculate_energy_potential(self, particles: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        """mean_j [cost_j + 1/2 U_j^T Lambda^{-1} U_j]."""
        return torch.mean(self.calculate_particle_energies(particles, cost))

    def sample_update_noise(
        self, number_of_particles: int, generator: torch.Generator | None = None,
        normals: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """eps ~ N(0, I_{M_k}); ``normals`` injects eps."""
        if normals is not None:
            return normals
        return torch.randn(
            (self.approximation_dimension, number_of_particles),
            generator=generator, dtype=self.dtype, device=self.device,
        )

    def _calculate_particle_update(
        self, particles: torch.Tensor, cost_derivative: torch.Tensor, step_size: float,
        noise: torch.Tensor,
    ) -> torch.Tensor:
        """-eta Vt^T k(Z,X) dc - eta Lambda^{-1} U + sqrt(2 eta) eps."""
        drift_data = self.train_projection.T @ cost_derivative
        drift_prior = particles / self.eigenvalues[:, None]
        return (
            -step_size * drift_data
            - step_size * drift_prior
            + math.sqrt(2.0 * step_size) * noise
        )

    # --- prediction -------------------------------------------------------------
    def _gram_induce(self, x: torch.Tensor) -> torch.Tensor:
        """k(x, Z) for x of shape (..., c, D) -> (..., c, M)."""
        flat = ard_gram(self.kernel.base_kernel, x.reshape(-1, x.shape[-1]), self.x_induce)
        return flat.reshape(*x.shape[:-1], self.x_induce.shape[0])

    def _gram_test(self, x: torch.Tensor, augmentation_samples: torch.Tensor | None) -> torch.Tensor:
        """The bottom-right block for x of shape (B, c, D) -> (B, c, c)."""
        base = self.kernel.base_kernel
        if self.scaling == "nystrom":
            # marginal variance of the Matheron prediction is exactly k(x, x)
            return torch.stack([ard_gram(base, xb) for xb in x])
        # r(x, x) over the approximation samples augmented for OOD fidelity;
        # a zero-row set means they are augmented already
        flat_x = x.reshape(-1, x.shape[-1])
        aug = flat_x if augmentation_samples is None else augmentation_samples
        samples = self.kernel.approximation_samples
        if aug.shape[0] > 0:
            samples = augment_approximation_samples(samples, aug)
        k_xs = ard_gram(base, flat_x, samples).reshape(*x.shape[:-1], samples.shape[0])
        return (k_xs @ k_xs.transpose(-1, -2)) / samples.shape[0]

    def predictive_noise_covariance(
        self,
        x: torch.Tensor,
        augmentation_samples: torch.Tensor | None = None,
        base_gram_x_induce: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Covariance of [basis coefficients; test values],
        [[Lambda, (k(x,Z) Vt Lambda)^T], [k(x,Z) Vt Lambda, k_x]], for x of
        shape (c, D) -> (M_k + c, M_k + c) or (B, c, D) -> batched."""
        batched = x.ndim == 3
        x3 = x if batched else _as_2d(x)[None]
        if base_gram_x_induce is None:
            base_gram_x_induce = self._gram_induce(x3)
        kxz = base_gram_x_induce if base_gram_x_induce.ndim == 3 else base_gram_x_induce[None]
        off = kxz @ self.scaled_eigenvectors * self.eigenvalues  # (B, c, M_k)
        gram_x = self._gram_test(x3, augmentation_samples)
        lam = torch.diag(self.eigenvalues).expand(x3.shape[0], -1, -1)
        cov = torch.cat(
            [torch.cat([lam, off.transpose(-1, -2)], dim=-1), torch.cat([off, gram_x], dim=-1)],
            dim=-2,
        )
        return cov if batched else cov[0]

    def sample_predictive_noise(
        self,
        particles: torch.Tensor,
        x: torch.Tensor,
        generator: GeneratorLike = None,
        augmentation_samples: torch.Tensor | None = None,
        base_gram_x_induce: torch.Tensor | None = None,
        normals: torch.Tensor | None = None,
        extra: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Joint MVN draw (..., M_k + c, J) over [coefficients; test values]
        (reference ``orthonormal.py:161-214``), plus the extra predictive
        noise where the basis has one; ``normals`` injects the standard
        normals and ``extra`` the extra noise."""
        cov = self.predictive_noise_covariance(x, augmentation_samples, base_gram_x_induce)
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
        """Matheron pathwise conditioning noise_x + k(x,Z) Vt (U - noise_Z)
        (reference ``orthonormal.py:216-244``); x of shape (c, D) or (B, c, D).
        The noise is ``noise``, else drawn with ``normals`` and ``extra``
        injected where given (:meth:`sample_predictive_noise`)."""
        x = x if x.ndim == 3 else _as_2d(x)
        base_gram_x_induce = self._gram_induce(x)
        if noise is None:
            noise = self.sample_predictive_noise(
                particles, x, generator=generator,
                augmentation_samples=augmentation_samples,
                base_gram_x_induce=base_gram_x_induce, normals=normals, extra=extra,
            )
        m_k = self.approximation_dimension
        out = noise[..., m_k:, :] + base_gram_x_induce @ (
            self.scaled_eigenvectors @ (particles - noise[..., :m_k, :])
        )
        if self.mean_constant != 0.0:
            out = out + self.mean_constant
        return out


def build_orthonormal_basis(
    kernel: PLSKernel,
    x_induce,
    x_train,
    eigenvalue_threshold: float = 0.0,
    additional_predictive_noise_distribution: object | None = None,
    verbose: bool = True,
    scaling: str = "reference",
    relative_eigenvalue_threshold: float | None = None,
    mean_constant: float = 0.0,
) -> OrthonormalBasis:
    """Build the basis on the kernel's device (reference
    ``orthonormal.py:22-68``). The eigh and the data-dependent thresholding
    run on the host in fp64 whatever the working dtype; so does the train
    projection k(Z,X)^T @ Vt, whose nystrom columns carry 1/lambda range.

    ``relative_eigenvalue_threshold`` drops eigenpairs with
    lambda <= rel * lambda_max (overriding ``eigenvalue_threshold`` when
    larger); practically required with ``scaling="nystrom"``."""
    device = kernel.base_kernel.device
    x_induce = _as_2d(as_tensor(x_induce, device=device))
    x_train = _as_2d(as_tensor(x_train, device=device))

    m = x_induce.shape[0]
    base_gram_induce = ard_gram(kernel.base_kernel, x_induce)  # (M, M), same input
    base_gram_induce_train = ard_gram(kernel.base_kernel, x_induce, x_train)  # (M, N)
    dtype = base_gram_induce.dtype

    eigenvalues, eigenvectors = np.linalg.eigh(
        base_gram_induce.cpu().numpy().astype(np.float64) / m
    )
    if relative_eigenvalue_threshold is not None and eigenvalues.size:
        eigenvalue_threshold = max(
            eigenvalue_threshold, float(relative_eigenvalue_threshold) * float(eigenvalues[-1])
        )
    keep = np.where(eigenvalues > eigenvalue_threshold)[0]
    eigenvalues = eigenvalues[keep]
    eigenvectors = eigenvectors[:, keep]
    if verbose:
        print(f"Number of eigenvalues kept: {eigenvalues.shape[0]} out of {m}")

    m_k = eigenvalues.shape[0]
    if scaling == "nystrom":
        # a kept eigenvalue at fp64 noise level makes the 1/lambda columns
        # overflow fp32 or inject garbage directions: fail fast
        if eigenvalues.size and float(eigenvalues[0]) <= 10.0 * np.finfo(
            np.float64
        ).eps * float(eigenvalues[-1]):
            raise ValueError(
                'scaling="nystrom" kept a numerically-zero eigenvalue '
                f"(lambda_min/lambda_max = {float(eigenvalues[0] / eigenvalues[-1]):.3e}); "
                "set relative_eigenvalue_threshold (e.g. 1e-10 or larger) to "
                "truncate the noise-level eigenpairs"
            )
        scaled_eigenvectors = eigenvectors / (np.sqrt(m) * eigenvalues)[None, :]
    elif scaling == "reference":
        scaled_eigenvectors = eigenvectors / np.sqrt(m_k * eigenvalues)[None, :]
    else:
        raise ValueError(f"Unknown ONB scaling {scaling!r}")
    train_projection = (
        base_gram_induce_train.cpu().numpy().astype(np.float64).T @ scaled_eigenvectors
    )
    as_working = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return OrthonormalBasis(
        kernel=kernel,
        x_induce=x_induce,
        eigenvalues=as_working(eigenvalues),
        scaled_eigenvectors=as_working(scaled_eigenvectors),
        base_gram_induce_train=base_gram_induce_train,
        train_projection=as_working(train_projection),
        additional_predictive_noise_distribution=additional_predictive_noise_distribution,
        scaling=scaling,
        mean_constant=float(mean_constant),
    )
