"""Carry weights and state into the port.

Each function takes a plain dict of numpy arrays (the field names of the JAX
package's dataclasses) and returns the port's object on ``device`` (the card
unless the caller asks for the CPU). With these, both packages compute on
the same basis and cost, eigenvector signs included.
"""

from __future__ import annotations

from projected_langevin_sampling_torch.models import link_functions
from projected_langevin_sampling_torch.models.basis.inducing_point import InducingPointBasis
from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    GaussianCost,
    MultiModalCost,
    PoissonCost,
    SmoothedBernoulliCost,
    StudentTCost,
)
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


def inducing_point_basis_from_numpy(params: dict, device=None) -> InducingPointBasis:
    """``{"kernel": {...}, "x_induce", "y_induce", "gram_induce",
    "base_gram_induce", "base_gram_induce_train", "inv_base_gram_induce",
    "train_projection", "noise_factor"}`` plus optional ``"mean_constant"``."""
    tensor = lambda name: as_tensor(params[name], device=device)  # noqa: E731
    return InducingPointBasis(
        kernel=pls_kernel_from_numpy(params["kernel"], device=device),
        **{name: tensor(name) for name in (
            "x_induce", "y_induce", "gram_induce", "base_gram_induce",
            "base_gram_induce_train", "inv_base_gram_induce", "train_projection",
            "noise_factor",
        )},
        mean_constant=float(params.get("mean_constant", 0.0)),
    )


def gaussian_cost_from_numpy(params: dict, device=None) -> GaussianCost:
    """``{"y_train": (N,), "observation_noise": ()}`` (identity link)."""
    return GaussianCost(
        y_train=as_tensor(params["y_train"], device=device),
        observation_noise=as_tensor(params["observation_noise"], device=device),
    )


_LINKS = {
    "identity": link_functions.IdentityLinkFunction,
    "sigmoid": link_functions.SigmoidLinkFunction,
    "probit": link_functions.ProbitLinkFunction,
    "square": link_functions.SquareLinkFunction,
}


def link_from_name(name: str, jitter: float | None = None) -> link_functions.PLSLinkFunction:
    """``"identity"``, ``"sigmoid"``, ``"probit"`` or ``"square"``; the
    probability links take an optional ``jitter``."""
    if name not in _LINKS:
        raise ValueError(f"Unknown link {name!r} (known: {sorted(_LINKS)})")
    return _LINKS[name]() if jitter is None else _LINKS[name](jitter=float(jitter))


def _link(params: dict, default: str):
    return link_from_name(params.get("link", default), params.get("jitter"))


def bernoulli_cost_from_numpy(params: dict, device=None) -> BernoulliCost:
    """``{"y_train": (N,)}`` plus optional ``"link"`` (default "sigmoid") and
    ``"jitter"``."""
    return BernoulliCost(
        y_train=as_tensor(params["y_train"], device=device),
        link_function=_link(params, "sigmoid"),
    )


def smoothed_bernoulli_cost_from_numpy(params: dict, device=None) -> SmoothedBernoulliCost:
    """``{"y_train": (N,), "smoothing_std": (N,), "gh_nodes": (Q,),
    "gh_weights": (Q,)}`` plus optional ``"gh_rule"``, ``"link"`` (only
    "sigmoid") and ``"jitter"``."""
    return SmoothedBernoulliCost(
        y_train=as_tensor(params["y_train"], device=device),
        smoothing_std=as_tensor(params["smoothing_std"], device=device),
        gh_nodes=as_tensor(params["gh_nodes"], device=device),
        gh_weights=as_tensor(params["gh_weights"], device=device),
        link_function=_link(params, "sigmoid"),
        gh_rule=params.get("gh_rule", "custom"),
    )


def poisson_cost_from_numpy(params: dict, device=None) -> PoissonCost:
    """``{"y_train": (N,)}`` plus optional ``"link"`` (default "square")."""
    return PoissonCost(
        y_train=as_tensor(params["y_train"], device=device), link_function=_link(params, "square")
    )


def student_t_cost_from_numpy(params: dict, device=None) -> StudentTCost:
    """``{"y_train": (N,), "degrees_of_freedom": float}`` plus optional
    ``"scale"`` (default 1) and ``"link"`` (default "identity")."""
    return StudentTCost(
        y_train=as_tensor(params["y_train"], device=device),
        degrees_of_freedom=float(params["degrees_of_freedom"]),
        scale=float(params.get("scale", 1.0)),
        link_function=_link(params, "identity"),
    )


def multimodal_cost_from_numpy(params: dict, device=None) -> MultiModalCost:
    """``{"y_train": (N,), "observation_noise": (), "shift": float,
    "bernoulli_noise": float}`` plus optional ``"link"`` (default
    "identity")."""
    return MultiModalCost(
        y_train=as_tensor(params["y_train"], device=device),
        observation_noise=as_tensor(params["observation_noise"], device=device),
        shift=float(params["shift"]),
        bernoulli_noise=float(params["bernoulli_noise"]),
        link_function=_link(params, "identity"),
    )
