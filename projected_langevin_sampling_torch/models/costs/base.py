"""Cost (likelihood) layer: behaviour shared by every PLS cost (counterpart
of ``projected_langevin_sampling_tpu/models/costs/base.py``; reference
``costs/base.py:8-133``).

The autograd fallback is one ``torch.func.grad`` of the summed
per-particle cost: particle j's cost depends only on column j of the (N, J)
predictions, so the gradient of the sum is the per-particle Jacobian.
"""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


class PLSCostMixin:
    """Method mixin for the cost dataclasses, which provide ``link_function``
    and ``y_train`` (and may provide ``observation_noise``) and implement
    ``calculate_cost``, ``calculate_cost_derivative`` and ``predict``.
    ``calculate_cost_and_derivative`` is the two in one call."""

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        """Per-particle cost: (N, J) -> (J,)."""
        raise NotImplementedError

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        """d cost_j / d F[n, j]: (N, J) -> (N, J)."""
        raise NotImplementedError

    def calculate_cost_and_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(cost (J,), dc (N, J)) of one F, as the ``off`` tier's step takes
        them: the two methods above, in that order. A cost with a kernel for
        both (the smoothed Bernoulli) overrides it."""
        f = untransformed_train_prediction_samples
        return self.calculate_cost(f), self.calculate_cost_derivative(f)

    def predict(self, prediction_samples: torch.Tensor):
        """The predictive distribution from (N, J) output-space samples."""
        raise NotImplementedError

    def _calculate_cost_derivative_autograd(
        self, untransformed_train_prediction_samples: torch.Tensor
    ) -> torch.Tensor:
        """Autograd fallback (reference ``costs/base.py:68-84``)."""
        return torch.func.grad(lambda f: torch.sum(self.calculate_cost(f)))(
            untransformed_train_prediction_samples
        )

    def sample_observation_noise(
        self,
        number_of_particles: int,
        generator: GeneratorLike = None,
        dtype=None,
    ) -> torch.Tensor:
        """(J,) observation-noise draws; zeros when the cost has none.

        Like the reference (``costs/base.py:86-115``) the stored
        ``observation_noise`` is used as the normal's std here, although the
        Gaussian cost treats it as a variance in the NLL; kept for parity."""
        noise = getattr(self, "observation_noise", None)
        if dtype is None:
            dtype = self.y_train.dtype
        device = self.y_train.device
        if noise is None:
            return torch.zeros(number_of_particles, dtype=dtype, device=device)
        generator = as_generator(generator, device=device)
        draws = torch.randn(number_of_particles, generator=generator, dtype=dtype, device=device)
        return torch.as_tensor(noise, dtype=dtype, device=device) * draws

    def predict_samples(
        self,
        untransformed_samples: torch.Tensor,
        observation_noise: torch.Tensor | None = None,
        generator: GeneratorLike = None,
    ) -> torch.Tensor:
        """link(F + observation noise) (reference ``costs/base.py:117-133``)."""
        if observation_noise is None:
            observation_noise = self.sample_observation_noise(
                number_of_particles=untransformed_samples.shape[1],
                generator=generator,
                dtype=untransformed_samples.dtype,
            )
        return self.link_function(untransformed_samples + observation_noise[None, :])
