"""Random-number plumbing for the PyTorch port.

The JAX package threads ``jax.random`` keys; here randomness comes from an
explicit ``torch.Generator``. Public functions take a seed, a generator or
None, and :func:`as_generator` turns any of these into a generator on the
device the draws are made on. The two frameworks give different numbers for
the same seed, so parity tests inject pre-drawn noise instead.
"""

from __future__ import annotations

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
