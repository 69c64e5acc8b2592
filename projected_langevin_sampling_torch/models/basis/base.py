"""Basis layer: behaviour shared by the function-space approximations
(counterpart of ``projected_langevin_sampling_tpu/models/basis/base.py:26-98``;
reference ``basis/base.py:7-193``).

Every constant factor (eigendecomposition, train projection) is computed once
at build time, so a training step is matrix products and elementwise work.
A basis may carry an ``additional_predictive_noise_distribution``
(``noise_distributions.py``), drawn on top of the whole Gaussian predictive
noise, basis block included.
"""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


class PLSBasisMixin:
    """Method mixin for the basis dataclasses, which provide
    ``approximation_dimension``, ``dtype``, ``device``,
    ``_initialise_particles``, ``sample_update_noise`` and
    ``_calculate_particle_update``."""

    def _initialise_particles_noise(
        self,
        number_of_particles: int,
        generator: GeneratorLike = None,
        mean: float = 0.0,
        stdev: float = 1.0,
    ) -> torch.Tensor:
        """(M, J) normal initial particles (reference ``basis/base.py:38-63``)."""
        generator = as_generator(generator, device=self.device)
        return mean + stdev * torch.randn(
            (self.approximation_dimension, number_of_particles),
            generator=generator,
            dtype=self.dtype,
            device=self.device,
        )

    def initialise_particles(
        self,
        number_of_particles: int,
        noise_only: bool = True,
        generator: GeneratorLike = None,
    ) -> torch.Tensor:
        """(M, J) initial particles (reference ``basis/base.py:81-104``)."""
        return self._initialise_particles(
            number_of_particles=number_of_particles,
            noise_only=noise_only,
            generator=generator,
        )

    def calculate_particle_update(
        self,
        particles: torch.Tensor,
        cost_derivative: torch.Tensor,
        step_size: float,
        noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
    ) -> torch.Tensor:
        """Shape-checked update (reference ``basis/base.py:143-168``);
        ``noise`` may be injected, otherwise it is drawn from ``generator``."""
        if particles.shape[0] != self.approximation_dimension:
            raise ValueError(
                f"Particles have shape {tuple(particles.shape)} but requires "
                f"({self.approximation_dimension}, J) dimension."
            )
        if noise is None:
            noise = self.sample_update_noise(
                number_of_particles=particles.shape[1],
                generator=as_generator(generator, device=self.device),
            )
        return self._calculate_particle_update(
            particles=particles,
            cost_derivative=cost_derivative,
            step_size=step_size,
            noise=noise,
        )

    def _sample_additional_predictive_noise(
        self, generator: torch.Generator, shape: tuple[int, ...]
    ) -> torch.Tensor | None:
        """A draw of the basis's extra predictive noise of ``shape``, or None
        when it has none (JAX ``base.py:92-98``)."""
        dist = getattr(self, "additional_predictive_noise_distribution", None)
        if dist is None:
            return None
        return dist.sample(generator, shape, dtype=self.dtype)

    def _with_additional_predictive_noise(
        self, noise: torch.Tensor, generator: GeneratorLike, extra: torch.Tensor | None = None
    ) -> torch.Tensor:
        """``noise`` plus the extra predictive noise: ``extra`` where given,
        else drawn from ``generator`` after the Gaussian draw; one independent
        draw per block of a batched (B, M + c, J) noise, as the JAX package's
        per-chunk draws."""
        if extra is None:
            extra = self._sample_additional_predictive_noise(
                as_generator(generator, device=self.device), tuple(noise.shape)
            )
        return noise if extra is None else noise + extra

    def draw_predictive_normals(
        self, generator: torch.Generator, shape: tuple[int, ...]
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(normals, extra)``: the standard normals of a predictive draw of
        ``shape`` (..., M + c, J) and the basis's extra predictive noise of
        the same shape (None where it has none), from ``generator`` in the
        order :meth:`sample_predictive_noise` draws them. Given back to
        ``predict_untransformed_samples``, they reproduce its own draw; a
        batch's blocks may take their slices of them."""
        normals = torch.randn(shape, generator=generator, dtype=self.dtype, device=self.device)
        return normals, self._sample_additional_predictive_noise(generator, shape)
