"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: small ONB and IPB models built by the JAX package and carried
across with ``projected_langevin_sampling_torch.convert``, on the CPU in
fp64."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_tpu.models import gaussian_process as jgp
from projected_langevin_sampling_tpu.models.basis import (
    build_inducing_point_basis,
    build_orthonormal_basis,
)
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


@contextlib.contextmanager
def one_thread():
    """The port's mains on one host thread: their steps are many small ops,
    which the test workers' oversubscribed thread pools slow many times
    over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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


def jax_ipb(n=64, m=12, lengthscale=0.4, observation_noise=0.1, seed=0, mean_constant=0.0):
    """A JAX IPB basis (Z = linspace(-2, 2, m), y(Z) = sin(2Z)) and Gaussian
    cost on the data of :func:`jax_onb`; returns (basis, cost, x, y)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2, 2, (n, 1)), axis=0)
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)
    kernel = PLSKernel(
        base_kernel=ARDKernel(jnp.asarray([lengthscale]), jnp.asarray(1.0)),
        approximation_samples=jnp.asarray(x),
    )
    z = np.linspace(-2, 2, m)
    basis = build_inducing_point_basis(kernel, jnp.asarray(z[:, None]), jnp.asarray(np.sin(2 * z)),
                                       jnp.asarray(x), mean_constant=mean_constant)
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
        "kernel": basis_params_kernel(basis.kernel),
        "x_induce": to_np(basis.x_induce),
        "eigenvalues": to_np(basis.eigenvalues),
        "scaled_eigenvectors": to_np(basis.scaled_eigenvectors),
        "base_gram_induce_train": to_np(basis.base_gram_induce_train),
        "train_projection": to_np(basis.train_projection),
        "scaling": basis.scaling,
        "mean_constant": basis.mean_constant,
    }


IPB_FIELDS = ("x_induce", "y_induce", "gram_induce", "base_gram_induce",
              "base_gram_induce_train", "inv_base_gram_induce", "train_projection",
              "noise_factor")


def ipb_params(basis) -> dict:
    """The JAX IPB basis as a dict of numpy arrays for ``convert``."""
    params = {name: to_np(getattr(basis, name)) for name in IPB_FIELDS}
    params["kernel"] = basis_params_kernel(basis.kernel)
    params["mean_constant"] = basis.mean_constant
    return params


def basis_params_kernel(kernel) -> dict:
    """A JAX PLS kernel as a dict of numpy arrays for ``convert``."""
    return {
        "base_kernel": {
            "lengthscales": to_np(kernel.base_kernel.lengthscales),
            "outputscale": to_np(kernel.base_kernel.outputscale),
        },
        "approximation_samples": to_np(kernel.approximation_samples),
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


def carried_ipb(basis, cost):
    """The port's IPB and cost carried over from the JAX objects, on the CPU."""
    return convert.inducing_point_basis_from_numpy(ipb_params(basis), device=CPU), carried_cost(cost)


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


def ipb_model(name, mean_constant=0.0):
    """JAX and port IPB models of cost ``name`` and the initial particles,
    as :func:`onb_model`."""
    jbasis, _, x, _ = jax_ipb(mean_constant=mean_constant)
    jcost = jax_cost(name, x)
    u0 = np.array(jbasis.initialise_particles(J, key=0))
    if name == "poisson":
        jbasis = jbasis.replace(mean_constant=2.0)
        u0 = 0.2 * u0
    tbasis, tcost = carried_ipb(jbasis, jcost)
    return jbasis, jcost, tbasis, tcost, u0


def update_noise(jbasis, steps=STEPS, seed=123):
    """The standard normals z the JAX scan draws from its per-step keys (the
    update noise itself on the ONB, the z of S z on the IPB)."""
    keys = jax.random.split(as_key(seed), steps)
    shape = (jbasis.approximation_dimension, J)
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype=jbasis.dtype)) for k in keys])


# --- baseline GPs (tests/test_torch_gp.py, tests/test_torch_calibration.py) ---
def gp_data(n=30, d=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)
    if d > 1:
        y = y + 0.3 * x[:, 1:].sum(1)
    return x, y


def gp_jax_kernel(d=1, outputscale=1.2):
    return ARDKernel(jnp.asarray(np.linspace(0.7, 1.1, d)), jnp.asarray(outputscale))


def kernel_params(kernel) -> dict:
    if isinstance(kernel, PLSKernel):
        return {"base_kernel": kernel_params(kernel.base_kernel),
                "approximation_samples": to_np(kernel.approximation_samples)}
    return {"lengthscales": to_np(kernel.lengthscales), "outputscale": to_np(kernel.outputscale)}


def likelihood_params(likelihood) -> dict:
    name = type(likelihood).__name__
    if name == "GaussianLikelihood":
        return {"kind": "gaussian", "noise": to_np(likelihood.noise)}
    if name == "StudentTLikelihood":
        return {"kind": "student_t", "noise": to_np(likelihood.noise),
                "degrees_of_freedom": likelihood.degrees_of_freedom}
    return {"kind": "bernoulli"}


def exact_gp_params(gp) -> dict:
    params = {"mean_constant": to_np(gp.mean_constant), "kernel": kernel_params(gp.kernel),
              "noise": to_np(gp.noise), "x_train": to_np(gp.x_train), "y_train": to_np(gp.y_train)}
    if gp.fixed_noise_variances is not None:
        params["fixed_noise_variances"] = to_np(gp.fixed_noise_variances)
    return params


def svgp_params(svgp) -> dict:
    return {"mean_constant": to_np(svgp.mean_constant), "kernel": kernel_params(svgp.kernel),
            "likelihood": likelihood_params(svgp.likelihood), "x_induce": to_np(svgp.x_induce),
            "variational_mean": to_np(svgp.variational_mean),
            "variational_chol": to_np(svgp.variational_chol), "jitter": svgp.jitter}


def jax_svgp(likelihood="gaussian", pls=False, fitted=True, d=1, m=6):
    """A JAX SVGP on :func:`gp_data` (inducing inputs its first m rows);
    ``fitted``: a random variational state."""
    x, y = gp_data(d=d)
    kernel = gp_jax_kernel(d)
    if pls:
        kernel = PLSKernel(base_kernel=kernel, approximation_samples=jnp.asarray(x))
    likelihoods = {
        "gaussian": jgp.GaussianLikelihood(noise=jnp.asarray(0.05)),
        "bernoulli": jgp.BernoulliLikelihood(),
        "student_t": jgp.StudentTLikelihood(noise=jnp.asarray(0.04), degrees_of_freedom=4.5),
    }
    svgp = jgp.init_svgp(0.2, kernel, likelihoods[likelihood], jnp.asarray(x[:m]))
    if fitted:
        rng = np.random.default_rng(5)
        svgp = svgp.replace(
            variational_mean=jnp.asarray(rng.normal(size=m)),
            variational_chol=jnp.asarray(np.tril(0.3 * rng.normal(size=(m, m))) + np.eye(m)),
        )
    if likelihood == "bernoulli":
        y = (y > 0).astype(np.float64)
    return svgp, x, y
