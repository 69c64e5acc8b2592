"""Carry weights and state into the port.

Each function takes a plain dict of numpy arrays (the field names of the JAX
package's dataclasses) and returns the port's object on ``device`` (the card
unless the caller asks for the CPU). With these, both packages compute on
the same basis, cost and baseline GP, eigenvector signs included. A
likelihood or an extra predictive-noise distribution is a dict with a
``"kind"`` beside its fields.
"""

from __future__ import annotations

from projected_langevin_sampling_torch.models import link_functions
from projected_langevin_sampling_torch.models.basis.inducing_point import InducingPointBasis
from projected_langevin_sampling_torch.models.basis.noise_distributions import (
    NormalPredictiveNoise,
    StudentTPredictiveNoise,
)
from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    GaussianCost,
    MultiModalCost,
    PoissonCost,
    SmoothedBernoulliCost,
    StudentTCost,
)
from projected_langevin_sampling_torch.models.gaussian_process import (
    SVGP,
    BernoulliLikelihood,
    ExactGP,
    GaussianLikelihood,
    StudentTLikelihood,
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


def kernel_from_numpy(params: dict, device=None) -> ARDKernel | PLSKernel:
    """A PLS kernel's dict (it has ``"base_kernel"``) or an ARD kernel's."""
    if "base_kernel" in params:
        return pls_kernel_from_numpy(params, device=device)
    return ard_kernel_from_numpy(params, device=device)


def student_t_predictive_noise_from_numpy(params: dict) -> StudentTPredictiveNoise:
    """``{"df": float}`` plus optional ``"loc"`` and ``"scale"``."""
    return StudentTPredictiveNoise(
        df=float(params["df"]), loc=float(params.get("loc", 0.0)),
        scale=float(params.get("scale", 1.0)),
    )


def normal_predictive_noise_from_numpy(params: dict) -> NormalPredictiveNoise:
    """Optional ``"loc"`` and ``"scale"``."""
    return NormalPredictiveNoise(loc=float(params.get("loc", 0.0)),
                                 scale=float(params.get("scale", 1.0)))


_NOISES = {"student_t": student_t_predictive_noise_from_numpy,
           "normal": normal_predictive_noise_from_numpy}


def predictive_noise_from_numpy(params: dict | None):
    """None, or ``{"kind": "student_t" | "normal", ...}``."""
    if params is None:
        return None
    return _NOISES[params["kind"]](params)


def orthonormal_basis_from_numpy(params: dict, device=None) -> OrthonormalBasis:
    """``{"kernel": {...}, "x_induce", "eigenvalues", "scaled_eigenvectors",
    "base_gram_induce_train", "train_projection"}`` plus optional
    ``"scaling"``, ``"mean_constant"`` and
    ``"additional_predictive_noise_distribution"``."""
    tensor = lambda name: as_tensor(params[name], device=device)  # noqa: E731
    return OrthonormalBasis(
        kernel=pls_kernel_from_numpy(params["kernel"], device=device),
        x_induce=tensor("x_induce"),
        eigenvalues=tensor("eigenvalues"),
        scaled_eigenvectors=tensor("scaled_eigenvectors"),
        base_gram_induce_train=tensor("base_gram_induce_train"),
        train_projection=tensor("train_projection"),
        additional_predictive_noise_distribution=predictive_noise_from_numpy(
            params.get("additional_predictive_noise_distribution")),
        scaling=params.get("scaling", "reference"),
        mean_constant=float(params.get("mean_constant", 0.0)),
    )


def inducing_point_basis_from_numpy(params: dict, device=None) -> InducingPointBasis:
    """``{"kernel": {...}, "x_induce", "y_induce", "gram_induce",
    "base_gram_induce", "base_gram_induce_train", "inv_base_gram_induce",
    "train_projection", "noise_factor"}`` plus optional ``"mean_constant"``
    and ``"additional_predictive_noise_distribution"``."""
    tensor = lambda name: as_tensor(params[name], device=device)  # noqa: E731
    return InducingPointBasis(
        kernel=pls_kernel_from_numpy(params["kernel"], device=device),
        **{name: tensor(name) for name in (
            "x_induce", "y_induce", "gram_induce", "base_gram_induce",
            "base_gram_induce_train", "inv_base_gram_induce", "train_projection",
            "noise_factor",
        )},
        additional_predictive_noise_distribution=predictive_noise_from_numpy(
            params.get("additional_predictive_noise_distribution")),
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


def gaussian_likelihood_from_numpy(params: dict, device=None) -> GaussianLikelihood:
    """``{"noise": ()}``."""
    return GaussianLikelihood(noise=as_tensor(params["noise"], device=device))


def bernoulli_likelihood_from_numpy(params: dict, device=None) -> BernoulliLikelihood:
    """No fields (the probit likelihood)."""
    return BernoulliLikelihood()


def student_t_likelihood_from_numpy(params: dict, device=None) -> StudentTLikelihood:
    """``{"noise": (), "degrees_of_freedom": float}``."""
    return StudentTLikelihood(noise=as_tensor(params["noise"], device=device),
                              degrees_of_freedom=float(params["degrees_of_freedom"]))


_LIKELIHOODS = {
    "gaussian": gaussian_likelihood_from_numpy,
    "bernoulli": bernoulli_likelihood_from_numpy,
    "student_t": student_t_likelihood_from_numpy,
}


def likelihood_from_numpy(params: dict, device=None):
    """``{"kind": "gaussian" | "bernoulli" | "student_t", ...}``."""
    return _LIKELIHOODS[params["kind"]](params, device=device)


def exact_gp_from_numpy(params: dict, device=None) -> ExactGP:
    """``{"mean_constant": (), "kernel": {ARD}, "noise": (), "x_train": (N, D),
    "y_train": (N,)}`` plus optional ``"fixed_noise_variances"`` (N,)."""
    fixed = params.get("fixed_noise_variances")
    return ExactGP(
        mean_constant=as_tensor(params["mean_constant"], device=device),
        kernel=ard_kernel_from_numpy(params["kernel"], device=device),
        noise=as_tensor(params["noise"], device=device),
        x_train=as_tensor(params["x_train"], device=device),
        y_train=as_tensor(params["y_train"], device=device),
        fixed_noise_variances=None if fixed is None else as_tensor(fixed, device=device),
    )


def svgp_from_numpy(params: dict, device=None) -> SVGP:
    """``{"mean_constant": (), "kernel": {ARD or PLS}, "likelihood": {"kind",
    ...}, "x_induce": (M, D), "variational_mean": (M,), "variational_chol":
    (M, M)}`` plus optional ``"jitter"``."""
    tensor = lambda name: as_tensor(params[name], device=device)  # noqa: E731
    return SVGP(
        mean_constant=tensor("mean_constant"),
        kernel=kernel_from_numpy(params["kernel"], device=device),
        likelihood=likelihood_from_numpy(params["likelihood"], device=device),
        x_induce=tensor("x_induce"),
        variational_mean=tensor("variational_mean"),
        variational_chol=tensor("variational_chol"),
        jitter=float(params.get("jitter", 1e-8)),
    )
