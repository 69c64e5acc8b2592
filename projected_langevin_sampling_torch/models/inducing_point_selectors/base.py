"""Inducing-point selection (counterpart of
``projected_langevin_sampling_tpu/models/inducing_point_selectors/base.py``;
reference ``inducing_point_selectors/base.py:8-34``). Selection is
sequential and runs once, on the host in numpy; results are tensors on the
kernel's device."""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from projected_langevin_sampling_torch.ops.kernels import ARDKernel


class InducingPointSelector(ABC):
    @abstractmethod
    def compute_induce_data(
        self,
        x,
        m: int,
        kernel: ARDKernel,
        rng: np.random.Generator | None = None,
        **params,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Select m inducing points from x; returns (induce_data, indices)."""
        raise NotImplementedError

    def __call__(
        self,
        x,
        m: int,
        kernel: ARDKernel,
        rng: np.random.Generator | None = None,
        **params,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        return self.compute_induce_data(x=x, m=m, kernel=kernel, rng=rng, **params)
