"""Ensemble-averaged kernels, likelihoods and mean constants (counterpart of
``experiments/constructors.py``): the parameter-wise average of the k
subsample fits, taken on the positive parameters as the JAX harness does."""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.models.gaussian_process import (
    ExactGP,
    GaussianLikelihood,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel


def construct_average_ard_kernel(kernels: list[ARDKernel]) -> ARDKernel:
    return ARDKernel(
        lengthscales=torch.mean(torch.stack([k.lengthscales for k in kernels]), dim=0),
        outputscale=torch.mean(torch.stack([k.outputscale for k in kernels]), dim=0),
    )


def construct_average_gaussian_likelihood(
    likelihoods: list[GaussianLikelihood],
) -> GaussianLikelihood:
    return GaussianLikelihood(
        noise=torch.mean(torch.stack([lik.noise for lik in likelihoods]), dim=0)
    )


def construct_average_gaussian_likelihood_from_models(
    models: list[ExactGP],
) -> GaussianLikelihood:
    return GaussianLikelihood(noise=torch.mean(torch.stack([m.noise for m in models]), dim=0))


def construct_average_mean_constant(models: list[ExactGP]) -> torch.Tensor:
    return torch.mean(torch.stack([m.mean_constant for m in models]), dim=0)
