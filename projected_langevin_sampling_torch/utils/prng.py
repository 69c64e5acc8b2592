"""Random-number plumbing for the PyTorch port (counterpart of
``projected_langevin_sampling_tpu/utils/prng.py``).

The JAX package threads ``jax.random`` keys; here randomness comes from an
explicit ``torch.Generator``. Public functions take a seed, a generator or
None, and :func:`as_generator` turns any of these into a generator on the
device the draws are made on. The two frameworks give different numbers for
the same seed, so parity tests inject pre-drawn noise instead.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from projected_langevin_sampling_torch.utils.device import resolve_device

GeneratorLike = int | torch.Generator | None


def as_generator(
    seed_or_generator: GeneratorLike, device=None, default_seed: int = 0
) -> torch.Generator:
    """A generator from an optional integer seed or an existing generator.

    A new generator lives on ``device`` (the card unless the caller asks for
    the CPU); an existing one is returned as it is."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    seed = default_seed if seed_or_generator is None else int(seed_or_generator)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def normal(
    generator: torch.Generator,
    shape: tuple[int, ...],
    dtype=torch.float32,
    mean: float = 0.0,
    stdev: float = 1.0,
) -> torch.Tensor:
    """Gaussian draws with explicit mean and stdev on the generator's device,
    the reference's ``torch.normal(mean, std, size)`` (``basis/base.py:38-63``)."""
    return mean + stdev * torch.randn(
        tuple(shape), generator=generator, dtype=dtype, device=generator.device
    )


def set_seed(seed: int = 42, device=None) -> torch.Generator:
    """Seed the host generators (numpy, random, PYTHONHASHSEED) and torch's
    global generators, as the reference's ``set_seed`` (``src/utils.py:8-22``)
    does, and return a generator on ``device`` (the card unless the caller
    asks for the CPU) seeded with ``seed``."""
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return as_generator(seed, device=device)


def sample_point(generator: GeneratorLike, x: torch.Tensor) -> torch.Tensor:
    """One random row of x, keeping the leading axis (size 1): the
    reference's ``sample_point`` (``src/samplers.py:47-62``), which centres
    the kNN training subsample. The index is drawn from ``generator``."""
    generator = as_generator(generator, device=x.device)
    index = int(torch.randint(0, x.shape[0], (1,), generator=generator, device=x.device))
    return x[index : index + 1]
