"""Additional predictive-noise distributions for heavy-tailed bases
(counterpart of ``projected_langevin_sampling_tpu/models/basis/noise_distributions.py``).

The reference passes a ``torch.distributions.Distribution`` (a StudentT in
the UCI Student-T experiments) into the basis as
``additional_predictive_noise_distribution`` and samples it on top of the
Gaussian predictive noise (``basis/orthonormal.py:210-213``,
``basis/inducing_point.py:197-201``). Here each is a frozen dataclass with
``sample(generator, shape, dtype)``, drawing from the generator it is given.

``torch.distributions.StudentT`` and ``torch._standard_gamma`` take no
generator, so the t variates are built here from the generator's normals and
uniforms: t = z / sqrt(g / df) with g ~ Gamma(df/2, scale 2), the gamma by
Marsaglia and Tsang's squeeze method. The fitted df is not an integer, so a
sum of squared normals would not do.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def standard_gamma(
    concentration: float, shape: tuple[int, ...], generator: torch.Generator
) -> torch.Tensor:
    """Gamma(concentration, scale 1) variates of ``shape`` in fp64 on the
    generator's device (Marsaglia and Tsang, ACM TOMS 26(3), 2000).

    For concentration a >= 1: d = a - 1/3, c = 1/sqrt(9 d); draw x ~ N(0, 1)
    and u ~ U(0, 1), v = (1 + c x)^3, and accept d v where v > 0 and
    log u < x^2/2 + d - d v + d log v (at least 95% of proposals). Rejected
    entries are drawn again, all at once, until none is left. For a < 1 the
    draw at a + 1 is multiplied by u^(1/a)."""
    a = float(concentration)
    if not a > 0.0:
        raise ValueError(f"gamma concentration must be positive, got {a}")
    device = generator.device
    boosted = a < 1.0
    d = (a + 1.0 if boosted else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        k = todo.numel()
        x = torch.randn(k, generator=generator, dtype=torch.float64, device=device)
        u = torch.rand(k, generator=generator, dtype=torch.float64, device=device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp_min(v, torch.finfo(torch.float64).tiny))
        accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        out[todo[accept]] = d * v[accept]
        todo = todo[~accept]
    if boosted:
        u = torch.rand(n, generator=generator, dtype=torch.float64, device=device)
        out = out * u ** (1.0 / a)
    return out.reshape(shape)


def student_t(df: float, shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Standard Student-T variates of ``shape`` in fp64: z / sqrt(g / df),
    z ~ N(0, 1), g ~ chi^2(df) = Gamma(df/2, scale 2)."""
    z = torch.randn(shape, generator=generator, dtype=torch.float64, device=generator.device)
    g = 2.0 * standard_gamma(0.5 * float(df), shape, generator)
    return z / torch.sqrt(g / float(df))


@dataclasses.dataclass(frozen=True)
class StudentTPredictiveNoise:
    df: float
    loc: float = 0.0
    scale: float = 1.0

    def sample(
        self, generator: torch.Generator, shape: tuple[int, ...], dtype=None
    ) -> torch.Tensor:
        draws = student_t(self.df, tuple(shape), generator)
        return (self.loc + self.scale * draws).to(dtype or torch.get_default_dtype())


@dataclasses.dataclass(frozen=True)
class NormalPredictiveNoise:
    loc: float = 0.0
    scale: float = 1.0

    def sample(
        self, generator: torch.Generator, shape: tuple[int, ...], dtype=None
    ) -> torch.Tensor:
        draws = torch.randn(
            tuple(shape), generator=generator, dtype=dtype or torch.get_default_dtype(),
            device=generator.device,
        )
        return self.loc + self.scale * draws
