"""Link functions from untransformed function samples to the output space
(counterpart of ``projected_langevin_sampling_tpu/models/link_functions.py``;
reference ``link_functions.py:6-80``)."""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod

import torch


class PLSLinkFunction(ABC):
    @abstractmethod
    def transform(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        return self.transform(y)


def _probability_clip(p: torch.Tensor, jitter: float) -> torch.Tensor:
    """Clip to [jitter, 1 - jitter] with the jitter raised to at least the
    dtype's epsilon: in fp32 ``1 - 1e-10`` rounds to 1.0, the upper clip
    would do nothing and a Bernoulli ``log(1 - p)`` would be -inf. In fp64
    the floor (2.2e-16) is below 1e-10 and the reference is unchanged."""
    eps = torch.finfo(p.dtype).eps
    jit = torch.clamp_min(torch.full((), jitter, dtype=p.dtype, device=p.device), eps)
    return torch.minimum(torch.maximum(p, jit), 1.0 - jit)


@dataclasses.dataclass(frozen=True)
class IdentityLinkFunction(PLSLinkFunction):
    """Output space R (regression)."""

    def transform(self, y: torch.Tensor) -> torch.Tensor:
        return y


@dataclasses.dataclass(frozen=True)
class SigmoidLinkFunction(PLSLinkFunction):
    """Output space (0, 1), clipped to [jitter, 1 - jitter]."""

    jitter: float = 1e-10

    def transform(self, y: torch.Tensor) -> torch.Tensor:
        return _probability_clip(torch.sigmoid(y), self.jitter)


@dataclasses.dataclass(frozen=True)
class ProbitLinkFunction(PLSLinkFunction):
    """Standard-normal CDF via erf, clipped."""

    jitter: float = 1e-10

    def transform(self, y: torch.Tensor) -> torch.Tensor:
        cdf = 0.5 * (1.0 + torch.erf(y / math.sqrt(2.0)))
        return _probability_clip(cdf, self.jitter)


@dataclasses.dataclass(frozen=True)
class SquareLinkFunction(PLSLinkFunction):
    """Output space R+ (e.g. Poisson rates)."""

    def transform(self, y: torch.Tensor) -> torch.Tensor:
        return torch.square(y)
