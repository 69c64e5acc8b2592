"""Device placement: the port runs on the card unless the caller asks for
the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``cuda``)."""
    return torch.device("cuda" if device is None else device)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor from an array-like. A tensor keeps its device unless
    ``device`` is given; anything else goes to :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        if device is None and dtype is None:
            return x
        return x.to(device=x.device if device is None else device, dtype=dtype)
    # a copy: the source may be read-only (a JAX buffer, a memory map)
    return torch.as_tensor(np.array(x), dtype=dtype, device=resolve_device(device))
