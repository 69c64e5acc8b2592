"""PLS facade, the public model object (counterpart of
``projected_langevin_sampling_tpu/models/pls.py``; reference
``projected_langevin_sampling.py:7-204``): a thin delegation layer over a
basis and a cost."""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.basis.base import PLSBasisMixin
from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.ops.kernels import augment_approximation_samples
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


class PLS:
    """Projected Langevin Sampling model.

    N: number of training points; M: approximation dimension;
    J: number of particles; D: input dimension.
    """

    def __init__(self, basis: PLSBasisMixin, cost: PLSCostMixin, name: str | None = None):
        self.basis = basis
        self.cost = cost
        self.name: str = name if name is not None else "pls"

    @property
    def observation_noise(self):
        return getattr(self.cost, "observation_noise", None)

    @observation_noise.setter
    def observation_noise(self, value):
        self.cost = self.cost.replace(
            observation_noise=torch.as_tensor(value, device=self.cost.y_train.device)
        )

    # --- initialisation ------------------------------------------------------
    def initialise_particles(
        self,
        number_of_particles: int,
        noise_only: bool = True,
        generator: GeneratorLike = None,
        seed: int | None = None,
    ) -> torch.Tensor:
        if generator is None and seed is not None:
            generator = seed
        return self.basis.initialise_particles(
            number_of_particles=number_of_particles, noise_only=noise_only, generator=generator
        )

    def sample_observation_noise(
        self, number_of_particles: int, generator: GeneratorLike = None
    ) -> torch.Tensor:
        return self.cost.sample_observation_noise(number_of_particles, generator=generator)

    def sample_predictive_noise(
        self, particles: torch.Tensor, x: torch.Tensor, generator: GeneratorLike = None
    ) -> torch.Tensor:
        return self.basis.sample_predictive_noise(particles=particles, x=x, generator=generator)

    # --- training-time quantities ---------------------------------------------
    def calculate_cost(self, particles: torch.Tensor) -> torch.Tensor:
        """(J,) per-particle cost."""
        samples = self.basis.calculate_untransformed_train_prediction_samples(particles)
        return self.cost.calculate_cost(samples)

    def calculate_cost_derivative(self, particles: torch.Tensor) -> torch.Tensor:
        """(N, J) cost derivative at the current particles."""
        samples = self.basis.calculate_untransformed_train_prediction_samples(particles)
        return self.cost.calculate_cost_derivative(samples)

    def calculate_particle_update(
        self,
        particles: torch.Tensor,
        step_size: float,
        noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
    ) -> torch.Tensor:
        """(M, J) Langevin update; ``noise`` may be injected."""
        return self.basis.calculate_particle_update(
            particles=particles,
            cost_derivative=self.calculate_cost_derivative(particles),
            step_size=step_size,
            noise=noise,
            generator=generator,
        )

    def calculate_energy_potential(self, particles: torch.Tensor) -> torch.Tensor:
        """Scalar mean energy."""
        if particles.shape[0] != self.basis.approximation_dimension:
            raise ValueError(
                f"Particles have shape {tuple(particles.shape)} but requires "
                f"({self.basis.approximation_dimension}, J) dimension."
            )
        cost = self.calculate_cost(particles)
        return self.basis.calculate_energy_potential(particles=particles, cost=cost)

    # --- prediction -------------------------------------------------------------
    def predict_samples(
        self,
        particles: torch.Tensor,
        x: torch.Tensor,
        predictive_noise: torch.Tensor | None = None,
        observation_noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
        chunk_size: int | None = None,
        mesh=None,
    ) -> torch.Tensor:
        """(N*, J) output-space samples; noise may be injected.

        ``chunk_size``: draw the joint predictive per block of test points
        (O(N*/c (M + c)^3) instead of O((M + N*)^3)). Every point's marginal
        law is unchanged; only the correlations between points in different
        blocks are dropped. The blocks are one batch: one batched eigh, with
        the approximation samples augmented by the whole test batch once.

        ``mesh`` (with ``chunk_size``): spread the blocks over the mesh's last
        axis, their count padded to a multiple of it. Every rank draws the
        whole batch's normals from the same generator state and keeps its own
        blocks', computes them (its grams on the gram kernel), and one
        all-gather puts the blocks together; the padded rows are dropped. The
        draws are the single-device chunked call's at the same block count."""
        generator = as_generator(generator, device=particles.device)
        if chunk_size is None or x.shape[0] <= chunk_size or predictive_noise is not None:
            untransformed = self.basis.predict_untransformed_samples(
                particles=particles, x=x, noise=predictive_noise, generator=generator
            )
        else:
            n, c = x.shape[0], chunk_size
            n_blocks = -(-n // c)
            if mesh is not None:
                serve = mesh.shape[-1]
                n_blocks = -(-n_blocks // serve) * serve
            pad = n_blocks * c - n
            # pad with the last test point; duplicates only make a block's
            # covariance PSD-singular, which the eigenvalue clip handles
            x_padded = torch.cat([x, x[-1:].expand(pad, x.shape[1])]) if pad else x
            kernel = self.basis.kernel
            basis_aug = self.basis.replace(
                kernel=dataclasses.replace(
                    kernel,
                    approximation_samples=augment_approximation_samples(
                        kernel.approximation_samples, x
                    ),
                )
            )
            size, index = 1, 0
            if mesh is not None:
                from projected_langevin_sampling_torch.parallel.mesh import axis, gather_blocks

                group, size, index = axis(mesh, mesh.mesh_dim_names[-1])
            # the whole batch's draws on every rank, each rank's blocks sliced
            normals, extra = basis_aug.draw_predictive_normals(
                generator, (n_blocks, basis_aug.approximation_dimension + c, particles.shape[1])
            )
            mine = slice(index * n_blocks // size, (index + 1) * n_blocks // size)
            blocks = basis_aug.predict_untransformed_samples(
                particles=particles,
                x=x_padded.reshape(n_blocks, c, x.shape[1])[mine],
                normals=normals[mine],
                extra=None if extra is None else extra[mine],
                augmentation_samples=x.new_zeros((0, x.shape[1])),
            )
            if size > 1:
                blocks = gather_blocks(blocks, group, size)
            untransformed = blocks.reshape(n_blocks * c, particles.shape[1])[:n]
        return self.cost.predict_samples(
            untransformed_samples=untransformed,
            observation_noise=observation_noise,
            generator=generator,
        )

    def predict_untransformed_samples(
        self,
        particles: torch.Tensor,
        x: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
    ) -> torch.Tensor:
        return self.basis.predict_untransformed_samples(
            particles=particles, x=x, noise=noise, generator=generator
        )

    def predict(
        self,
        x: torch.Tensor,
        particles: torch.Tensor,
        predictive_noise: torch.Tensor | None = None,
        observation_noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
        chunk_size: int | None = None,
        mesh=None,
    ):
        prediction_samples = self.predict_samples(
            particles=particles,
            x=x,
            predictive_noise=predictive_noise,
            observation_noise=observation_noise,
            generator=generator,
            chunk_size=chunk_size,
            mesh=mesh,
        )
        return self.cost.predict(prediction_samples=prediction_samples)

    def __call__(self, x, particles, predictive_noise=None, observation_noise=None,
                 generator: GeneratorLike = None):
        return self.predict(
            x=x,
            particles=particles,
            predictive_noise=predictive_noise,
            observation_noise=observation_noise,
            generator=generator,
        )
