"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: small ONB models built by the JAX package and carried across with
``projected_langevin_sampling_torch.convert``, on the CPU in fp64."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_tpu.models.basis import build_orthonormal_basis
from projected_langevin_sampling_tpu.models import costs as jcosts
from projected_langevin_sampling_tpu.models.costs import GaussianCost
from projected_langevin_sampling_tpu.models.link_functions import ProbitLinkFunction
from projected_langevin_sampling_tpu.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_tpu.utils.prng import as_key

CPU = torch.device("cpu")
J, STEPS = 8, 120  # particles and steps of the training parity tests
# the general kernel's cost kind of each jax_cost name
ELIGIBLE = {
    "gaussian": "gaussian",
    "bernoulli": "bernoulli_sigmoid",
    "smoothed": "bernoulli_sigmoid_smoothed",
    "bernoulli_probit": "bernoulli_probit",
    "poisson": "poisson_square",
    "student_t": "student_t",
    "multimodal": "multimodal_identity",
}


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


def jax_cost(name: str, x: np.ndarray, seed: int = 1):
    """A JAX cost of kind ``name`` on the targets of f = sin(2x):
    "gaussian", "bernoulli", "bernoulli_probit", "smoothed" (smoothing std
    uniform(0.1, 1)), "poisson" (counts of rate 4 + f), "student_t" (df 4,
    scale 0.3) or "multimodal" (shift 2, weight 0.4, sigma 0.3)."""
    rng = np.random.default_rng(seed)
    f = np.sin(2 * x[:, 0])
    n = f.shape[0]
    labels = jnp.asarray((f + 0.2 * rng.normal(size=n) > 0).astype(np.float64))
    if name == "gaussian":
        return GaussianCost(y_train=jnp.asarray(f + 0.1 * rng.normal(size=n)),
                            observation_noise=jnp.asarray(0.1))
    if name == "bernoulli":
        return jcosts.BernoulliCost(y_train=labels)
    if name == "bernoulli_probit":
        return jcosts.BernoulliCost(y_train=labels, link_function=ProbitLinkFunction())
    if name == "smoothed":
        return jcosts.make_smoothed_bernoulli_cost(
            y_train=labels, smoothing_std=jnp.asarray(rng.uniform(0.1, 1.0, n)))
    if name == "poisson":
        return jcosts.PoissonCost(y_train=jnp.asarray(rng.poisson(4.0 + f).astype(np.float64)))
    if name == "student_t":
        return jcosts.StudentTCost(y_train=jnp.asarray(f + 0.1 * rng.standard_t(4.0, size=n)),
                                   degrees_of_freedom=4.0, scale=0.3)
    if name == "multimodal":
        y = f - 2.0 * (rng.uniform(size=n) < 0.4)
        return jcosts.MultiModalCost(y_train=jnp.asarray(y), observation_noise=jnp.asarray(0.3),
                                     shift=2.0, bernoulli_noise=0.4)
    raise ValueError(name)


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


_LINK_NAMES = {
    "IdentityLinkFunction": "identity",
    "SigmoidLinkFunction": "sigmoid",
    "ProbitLinkFunction": "probit",
    "SquareLinkFunction": "square",
}


def cost_params(cost) -> dict:
    """A JAX cost as a dict of numpy arrays and floats for ``convert``."""
    link = cost.link_function
    params = {"y_train": to_np(cost.y_train), "link": _LINK_NAMES[type(link).__name__]}
    if hasattr(link, "jitter"):
        params["jitter"] = link.jitter
    name = type(cost).__name__
    if name in ("GaussianCost", "MultiModalCost"):
        params["observation_noise"] = to_np(cost.observation_noise)
    if name == "SmoothedBernoulliCost":
        params.update(smoothing_std=to_np(cost.smoothing_std), gh_nodes=to_np(cost.gh_nodes),
                      gh_weights=to_np(cost.gh_weights), gh_rule=cost.gh_rule)
    if name == "StudentTCost":
        params.update(degrees_of_freedom=float(cost.degrees_of_freedom), scale=float(cost.scale))
    if name == "MultiModalCost":
        params.update(shift=float(cost.shift), bernoulli_noise=float(cost.bernoulli_noise))
    return params


_CONVERTERS = {
    "GaussianCost": convert.gaussian_cost_from_numpy,
    "BernoulliCost": convert.bernoulli_cost_from_numpy,
    "SmoothedBernoulliCost": convert.smoothed_bernoulli_cost_from_numpy,
    "PoissonCost": convert.poisson_cost_from_numpy,
    "StudentTCost": convert.student_t_cost_from_numpy,
    "MultiModalCost": convert.multimodal_cost_from_numpy,
}


def carried_cost(cost):
    """The port's cost carried over from any JAX cost, on the CPU."""
    return _CONVERTERS[type(cost).__name__](cost_params(cost), device=CPU)


def carried(basis, cost):
    """The port's (basis, cost) carried over from the JAX objects, on the CPU."""
    return convert.orthonormal_basis_from_numpy(basis_params(basis), device=CPU), carried_cost(cost)


def onb_model(name):
    """JAX and port models of cost ``name`` and the initial particles; the
    Poisson square link trains at a mean constant of 2 from small particles,
    so that F stays away from its pole at 0."""
    jbasis, _, x, _ = jax_onb()
    jcost = jax_cost(name, x)
    u0 = np.array(jbasis.initialise_particles(J, key=0))
    if name == "poisson":
        jbasis = jbasis.replace(mean_constant=2.0)
        u0 = 0.2 * u0
    tbasis, tcost = carried(jbasis, jcost)
    return jbasis, jcost, tbasis, tcost, u0


def update_noise(jbasis, steps=STEPS):
    """The standard normals the JAX scan draws from its per-step keys."""
    keys = jax.random.split(as_key(123), steps)
    return np.stack([np.asarray(jbasis.sample_update_noise(J, k)) for k in keys])
