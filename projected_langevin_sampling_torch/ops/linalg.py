"""PSD factorisation and multivariate-normal sampling (counterpart of
``projected_langevin_sampling_tpu/ops/linalg.py:25-81``).

A constant covariance is factored once (:func:`psd_sqrt`: eigh with the
negative eigenvalues clipped, as reference ``samplers.py:27-29``) and sampled
cheaply afterwards (:func:`sample_with_factor`). Every function works on a
leading batch dimension too, which the chunked predict uses in place of the
JAX package's ``vmap``. Each sampler takes pre-drawn standard normals as an
alternative to a generator: that is the parity hook of the tests.
"""

from __future__ import annotations

import numpy as np
import torch


def psd_sqrt(cov: torch.Tensor) -> torch.Tensor:
    """Factor S with S @ S^T == clip_psd(cov), for (..., M, M)."""
    eigenvalues, eigenvectors = torch.linalg.eigh(cov)
    eigenvalues = torch.clamp_min(eigenvalues, 0.0)
    return eigenvectors * torch.sqrt(eigenvalues)[..., None, :]


def psd_sqrt_host(cov: torch.Tensor) -> torch.Tensor:
    """:func:`psd_sqrt` in host fp64, cast back to ``cov``'s dtype and
    device (build-time factors of fp32 runs)."""
    cov64 = cov.detach().cpu().numpy().astype(np.float64)
    eigenvalues, eigenvectors = np.linalg.eigh(cov64)
    factor = eigenvectors * np.sqrt(np.clip(eigenvalues, 0.0, None))[..., None, :]
    return torch.as_tensor(factor, dtype=cov.dtype, device=cov.device)


def sample_with_factor(
    factor: torch.Tensor,
    size: int,
    mean: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    normals: torch.Tensor | None = None,
) -> torch.Tensor:
    """``size`` samples (..., M, size) = factor @ z (+ mean), z standard
    normal of shape (..., K, size): injected as ``normals`` or drawn from
    ``generator``."""
    if normals is None:
        shape = (*factor.shape[:-2], factor.shape[-1], size)
        normals = torch.randn(
            shape, generator=generator, dtype=factor.dtype, device=factor.device
        )
    samples = factor @ normals
    if mean is not None:
        samples = samples + mean[..., :, None]
    return samples


def sample_multivariate_normal(
    mean: torch.Tensor,
    cov: torch.Tensor,
    size: tuple[int, ...] | int | None = None,
    generator: torch.Generator | None = None,
    normals: torch.Tensor | None = None,
    factor: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-shot MVN samples with negative-eigenvalue clipping, shape
    (*size, M) with samples in rows (reference ``samplers.py:6-44``).
    ``factor`` skips the factorisation; ``normals`` (M, prod(size)) skips the
    draw."""
    if size is None:
        size = (1,)
    if isinstance(size, int):
        size = (size,)
    if factor is None:
        factor = psd_sqrt(cov)
    num = int(np.prod(size))
    samples = sample_with_factor(factor, num, mean=mean, generator=generator, normals=normals)
    return samples.T.reshape(*size, mean.shape[0])
