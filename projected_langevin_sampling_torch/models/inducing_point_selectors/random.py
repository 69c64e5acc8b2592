"""Uniform-random inducing-point selection (counterpart of
``projected_langevin_sampling_tpu/models/inducing_point_selectors/random.py``;
reference ``inducing_point_selectors/random.py:9-18``): the first m entries
of a numpy permutation, so the same generator state picks the same rows in
both packages."""

from __future__ import annotations

import numpy as np
import torch

from projected_langevin_sampling_torch.models.inducing_point_selectors.base import (
    InducingPointSelector,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel
from projected_langevin_sampling_torch.utils.device import as_tensor


class RandomInducingPointSelector(InducingPointSelector):
    def compute_induce_data(
        self,
        x,
        m: int,
        kernel: ARDKernel | None = None,
        rng: np.random.Generator | None = None,
        **params,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(x[indices], indices) on x's device (a tensor's own, else the
        kernel's, else the card)."""
        if rng is None:
            rng = np.random
        if isinstance(x, torch.Tensor):
            device = x.device
        else:
            device = kernel.device if kernel is not None else None
            x = as_tensor(x, device=device)
        indices = rng.permutation(x.shape[0])[:m]
        index = torch.as_tensor(indices, device=x.device)
        return x[index], index
