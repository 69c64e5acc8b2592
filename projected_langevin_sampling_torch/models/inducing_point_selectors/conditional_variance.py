"""Greedy conditional-variance inducing-point selection (counterpart of
``projected_langevin_sampling_tpu/models/inducing_point_selectors/conditional_variance.py``;
reference ``conditional_variance.py:10-120``).

Greedy MAP inference for a DPP, a partial pivoted Cholesky of the kernel
matrix: each round picks the point with the largest remaining conditional
variance and downdates the rest with the new pivot column. A random
permutation first breaks ties; the selection may stop early once
tr(Kff - Qff) falls below ``threshold``. The loop is host numpy; the pivot
columns are grams of the port's ``ard_gram`` on the kernel's device.
"""

from __future__ import annotations

import numpy as np
import torch

from projected_langevin_sampling_torch.models.inducing_point_selectors.base import (
    InducingPointSelector,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, ard_gram


class ConditionalVarianceInducingPointSelector(InducingPointSelector):
    def __init__(self, threshold: float | None = 0.0):
        self.threshold = threshold

    def compute_induce_data(
        self,
        x,
        m: int,
        kernel: ARDKernel,
        rng: np.random.Generator | None = None,
        jitter: float = 1e-12,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        if m <= 1:
            raise ValueError("Must have at least 2 inducing points")
        if rng is None:
            rng = np.random
        x_np = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if x_np.ndim == 1:
            x_np = x_np[:, None]
        n = x_np.shape[0]
        device = kernel.device

        perm = rng.permutation(n)  # random tie-breaking
        xp = x_np[perm]
        xp_t = torch.as_tensor(xp, device=device)

        to_host = lambda t: t.cpu().numpy().astype(np.float64)  # noqa: E731
        di = to_host(ard_gram(kernel, xp_t, xp_t, diag=True)) + jitter
        chosen = np.empty(m, dtype=int)
        chosen[0] = int(np.argmax(di))
        ci = np.zeros((m - 1, n))  # rows of the partial pivoted-Cholesky factor
        selected_count = 1
        for i in range(m - 1):
            j = int(chosen[i])
            dj = np.sqrt(di[j])
            cj = ci[:i, j]
            pivot_col = to_host(ard_gram(kernel, xp_t, xp_t[j : j + 1]))[:, 0]  # k(X, x_j)
            pivot_col = np.round(pivot_col, 20)
            pivot_col[j] += jitter
            ei = (pivot_col - cj @ ci[:i]) / dj
            ci[i, :] = ei
            di = np.clip(di - np.square(ei), 0.0, None)
            # next pivot: the largest remaining variance not yet selected
            for candidate in np.argsort(di)[::-1]:
                if int(candidate) not in chosen[: i + 1]:
                    chosen[i + 1] = int(candidate)
                    break
            selected_count = i + 2
            if self.threshold is not None and float(np.sum(di)) < self.threshold:
                print("ConditionalVariance: Terminating selection of inducing points early.")
                break
        chosen = chosen[:selected_count]
        return (
            torch.as_tensor(xp[chosen], device=device),
            torch.as_tensor(perm[chosen], device=device),
        )
