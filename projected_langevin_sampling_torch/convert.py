"""Carry weights and state into the port.

Each function takes a plain dict of numpy arrays (the field names of the JAX
package's dataclasses) and returns the port's object on ``device`` (the card
unless the caller asks for the CPU). With these, both packages compute on
the same basis and cost, eigenvector signs included.
"""

from __future__ import annotations

from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.costs.gaussian import GaussianCost
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_torch.utils.device import as_tensor


def ard_kernel_from_numpy(params: dict, device=None) -> ARDKernel:
    """``{"lengthscales": (D,), "outputscale": ()}``."""
    return ARDKernel(
        lengthscales=as_tensor(params["lengthscales"], device=device),
        outputscale=as_tensor(params["outputscale"], device=device),
    )


def pls_kernel_from_numpy(params: dict, device=None) -> PLSKernel:
    """``{"base_kernel": {...}, "approximation_samples": (S, D)}``."""
    return PLSKernel(
        base_kernel=ard_kernel_from_numpy(params["base_kernel"], device=device),
        approximation_samples=as_tensor(params["approximation_samples"], device=device),
    )


def orthonormal_basis_from_numpy(params: dict, device=None) -> OrthonormalBasis:
    """``{"kernel": {...}, "x_induce", "eigenvalues", "scaled_eigenvectors",
    "base_gram_induce_train", "train_projection"}`` plus optional
    ``"scaling"`` and ``"mean_constant"``."""
    tensor = lambda name: as_tensor(params[name], device=device)  # noqa: E731
    return OrthonormalBasis(
        kernel=pls_kernel_from_numpy(params["kernel"], device=device),
        x_induce=tensor("x_induce"),
        eigenvalues=tensor("eigenvalues"),
        scaled_eigenvectors=tensor("scaled_eigenvectors"),
        base_gram_induce_train=tensor("base_gram_induce_train"),
        train_projection=tensor("train_projection"),
        scaling=params.get("scaling", "reference"),
        mean_constant=float(params.get("mean_constant", 0.0)),
    )


def gaussian_cost_from_numpy(params: dict, device=None) -> GaussianCost:
    """``{"y_train": (N,), "observation_noise": ()}`` (identity link)."""
    return GaussianCost(
        y_train=as_tensor(params["y_train"], device=device),
        observation_noise=as_tensor(params["observation_noise"], device=device),
    )
