"""Synthetic 1-D benchmark curves (counterpart of ``experiments/curves/curves.py``).

Each curve is standardised to zero mean and unit std (``ddof=1``) over the
queried grid; ``regression`` adds iid Gaussian noise and ``classification``
draws Bernoulli labels through a sigmoid. The draws come from an explicit
``torch.Generator``, by default a CPU generator seeded with the curve's seed
(or 0), so a main makes the same data on every device; the numbers are not
the JAX harness's, whose draws come from ``jax.random``.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import torch

from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


def host_generator(generator: GeneratorLike, default_seed: int = 0) -> torch.Generator:
    """``generator`` as it is, or a CPU generator seeded with it (or with
    ``default_seed``)."""
    return as_generator(generator, device="cpu", default_seed=default_seed)


class Curve(ABC):
    seed: int

    @staticmethod
    @abstractmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def calculate_curve(self, x: torch.Tensor) -> torch.Tensor:
        curve = self._calculate_curve(x)
        return (curve - torch.mean(curve)) / torch.std(curve, correction=1)

    def regression(
        self, x: torch.Tensor, sigma_true: float, generator: GeneratorLike = None
    ) -> torch.Tensor:
        """The curve plus ``sigma_true`` times standard normals of x's shape,
        drawn on the generator's device, flattened."""
        generator = host_generator(generator, default_seed=self.seed)
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=generator.device)
        return (self.calculate_curve(x) + sigma_true * noise.to(x.device)).reshape(-1)

    @staticmethod
    def classification(y_curve: torch.Tensor, generator: GeneratorLike = None) -> torch.Tensor:
        """Labels in {0., 1.} (y_curve's dtype) with P(1) = sigmoid(y_curve)."""
        generator = host_generator(generator)
        probabilities = torch.sigmoid(y_curve).to(generator.device)
        return torch.bernoulli(probabilities, generator=generator).to(y_curve.device)


class Curve1(Curve):
    __name__ = r"$y=2 \sin(0.35 \pi x^2)$"
    seed: int = 1

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 2 * torch.sin((x**2) * 0.35 * math.pi)


class Curve2(Curve):
    __name__ = r"$y=2\sin(1.5\pi x)$"
    seed: int = 2

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 2 * torch.sin(1.5 * x * math.pi)


class Curve3(Curve):
    __name__ = r"$y=1.2 \cos(1.5 \pi x)$ - 0.25x"
    seed: int = 3

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 1.2 * torch.cos(x * (1.5 * math.pi)) - 0.25 * x


class Curve4(Curve):
    __name__ = r"$y=2\sin(0.5\pi x) + 0.6 \cos(2 \pi x) + \sin(\pi x)$"
    seed: int = 4

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return (
            2 * torch.sin(x * (0.5 * math.pi))
            + 0.6 * torch.cos(x * (2 * math.pi))
            + torch.sin(x * math.pi)
        )


class Curve5(Curve):
    __name__ = r"$y=2 \sin(1.5\pi x) + 0.25 x$"
    seed: int = 5

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 2 * torch.sin(1.5 * math.pi * x) + 0.25 * x


class Curve6(Curve):
    __name__ = r"$y=2 \sin(0.5\pi x^2) + 0.1x$"
    seed: int = 6

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 2 * torch.sin(0.5 * math.pi * x**2) + 0.1 * x


class Curve7(Curve):
    __name__ = r"$y=4\sin(\pi x) + 2\sin(2 \pi x) -x$"
    seed: int = 7

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 4 * torch.sin(x * math.pi) + 2 * torch.sin(x * (2 * math.pi)) - x


class Curve8(Curve):
    __name__ = r"$y=6\cos(\pi x) + 3\sin(2 \pi x) -x^2$"
    seed: int = 8

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return 6 * torch.cos(x * math.pi) + 3 * torch.sin(x * (2 * math.pi)) - x**2


class Curve9(Curve):
    __name__ = r"$y=\sin(0.3 \pi (x-2)^2) + 0.1x$"
    seed: int = 9

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return torch.sin(((x - 2) ** 2) * 0.3 * math.pi) + 0.1 * x


class Curve10(Curve):
    __name__ = r"$y=\sqrt{9-x^2} + \sin(\pi x)$"
    seed: int = 10

    @staticmethod
    def _calculate_curve(x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(9 - x**2) + torch.sin(math.pi * x)


CURVE_FUNCTIONS = [
    Curve1(),
    Curve2(),
    Curve3(),
    Curve4(),
    Curve5(),
    Curve6(),
    Curve7(),
    Curve8(),
    Curve9(),
    Curve10(),
]



def curves_of(curve: int | None) -> list[Curve]:
    """The mains' ``--curve``: that curve (1-based), or all ten."""
    return CURVE_FUNCTIONS if curve is None else [CURVE_FUNCTIONS[curve - 1]]
