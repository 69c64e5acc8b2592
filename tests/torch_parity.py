"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: small ONB models built by the JAX package and carried across with
``projected_langevin_sampling_torch.convert``, on the CPU in fp64."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_tpu.models.basis import build_orthonormal_basis
from projected_langevin_sampling_tpu.models.costs import GaussianCost
from projected_langevin_sampling_tpu.ops.kernels import ARDKernel, PLSKernel

CPU = torch.device("cpu")


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def jax_onb(n=64, m=16, lengthscale=0.4, observation_noise=0.1, seed=0, **build_kwargs):
    """A JAX ONB basis and Gaussian cost on 1-D sin data; returns
    (basis, cost, x, y) with x, y numpy."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2, 2, (n, 1)), axis=0)
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)
    kernel = PLSKernel(
        base_kernel=ARDKernel(jnp.asarray([lengthscale]), jnp.asarray(1.0)),
        approximation_samples=jnp.asarray(x),
    )
    z = jnp.asarray(np.linspace(-2, 2, m)[:, None])
    build_kwargs.setdefault("eigenvalue_threshold", 1e-3)
    basis = build_orthonormal_basis(kernel, z, jnp.asarray(x), verbose=False, **build_kwargs)
    cost = GaussianCost(y_train=jnp.asarray(y), observation_noise=jnp.asarray(observation_noise))
    return basis, cost, x, y


def basis_params(basis) -> dict:
    """The JAX ONB basis as a dict of numpy arrays for ``convert``."""
    return {
        "kernel": {
            "base_kernel": {
                "lengthscales": to_np(basis.kernel.base_kernel.lengthscales),
                "outputscale": to_np(basis.kernel.base_kernel.outputscale),
            },
            "approximation_samples": to_np(basis.kernel.approximation_samples),
        },
        "x_induce": to_np(basis.x_induce),
        "eigenvalues": to_np(basis.eigenvalues),
        "scaled_eigenvectors": to_np(basis.scaled_eigenvectors),
        "base_gram_induce_train": to_np(basis.base_gram_induce_train),
        "train_projection": to_np(basis.train_projection),
        "scaling": basis.scaling,
        "mean_constant": basis.mean_constant,
    }


def carried(basis, cost):
    """The port's (basis, cost) carried over from the JAX objects, on the CPU."""
    return (
        convert.orthonormal_basis_from_numpy(basis_params(basis), device=CPU),
        convert.gaussian_cost_from_numpy(
            {"y_train": to_np(cost.y_train), "observation_noise": to_np(cost.observation_noise)},
            device=CPU,
        ),
    )
