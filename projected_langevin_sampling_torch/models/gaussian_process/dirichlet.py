"""Dirichlet-based classification targets (counterpart of
``projected_langevin_sampling_tpu/models/gaussian_process/dirichlet.py``;
Milios et al. 2018, "Dirichlet-based Gaussian Processes for Large-scale
Calibrated Classification").

The reference's classification experiments learn kernel hyperparameters by
regressing on Dirichlet-transformed labels (gpytorch's
``DirichletClassificationLikelihood``): one GP per class on logit-scale
targets with fixed per-point noise. This is gpytorch's ``_prepare_targets``,
computed on the host in fp64.
"""

from __future__ import annotations

import numpy as np
import torch

from projected_langevin_sampling_torch.utils.device import as_tensor


def dirichlet_classification_targets(
    labels, alpha_epsilon: float = 0.01, device=None
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Integer class labels -> per-class regression targets:

        alpha[c, i]  = alpha_epsilon (+1 where labels[i] == c)
        sigma2[c, i] = log(1/alpha + 1)
        target[c, i] = log(alpha) - sigma2/2

    Returns (targets (C, N), noise variances (C, N), C) on the labels'
    device (a tensor's own, else ``device``, the card unless the caller asks
    for the CPU), in the labels' dtype if it is floating, else fp32. Pass the
    noise variances as ``fixed_noise_variances`` to ``fit_exact_gp``."""
    labels = as_tensor(labels, device=device)
    int_labels = labels.detach().cpu().numpy().astype(np.int64)
    num_classes = int(int_labels.max()) + 1
    one_hot = np.eye(num_classes, dtype=np.float64)[int_labels].T  # (C, N)
    alpha = alpha_epsilon + one_hot
    sigma2 = np.log(1.0 / alpha + 1.0)
    targets = np.log(alpha) - 0.5 * sigma2
    dtype = labels.dtype if labels.dtype.is_floating_point else torch.float32
    as_out = lambda a: torch.as_tensor(a, dtype=dtype, device=labels.device)  # noqa: E731
    return as_out(targets), as_out(sigma2), num_classes
