"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: small ONB and IPB models built by the JAX package and carried
across with ``projected_langevin_sampling_torch.convert``, on the CPU in
fp64."""

from __future__ import annotations

import contextlib
import inspect
import os

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


# --- the carrier: a JAX main's PLS draws in the port's main -------------------
def jax_run_normals(key, num_steps: int, shape, dtype, rotation=None):
    """``draw(start, n)`` for ``NoiseChunks``: the standard normals of steps
    start .. start + n - 1 of a JAX ``train_pls`` run on ``key``, as its scans
    draw them (``training.py:707``, ``:838``, ``:900``, ``:944``): keys
    ``split(key, T)``, or for a run longer than ``_SCAN_CHUNK_STEPS``
    ``split(fold_in(key, c), n_c)`` of chunk c (``:1063``), and
    ``normal(key_t, shape, dtype)``. ``rotation`` (M, M) maps each step's
    normals (the spectral tier's W-space draws into the U coordinates that
    the port's tier rotates back)."""
    from projected_langevin_sampling_tpu import training as jtraining

    limit = jtraining._SCAN_CHUNK_STEPS
    segment = limit if num_steps > limit else max(num_steps, 1)
    normals = jax.jit(jax.vmap(lambda k: jax.random.normal(k, tuple(shape), dtype=dtype)))
    cached = {}

    def keys_of(c):
        if c not in cached:
            cached.clear()
            base = key if num_steps <= limit else jax.random.fold_in(key, c)
            cached[c] = jax.random.split(base, min(segment, num_steps - c * segment))
        return cached[c]

    def draw(start: int, n: int) -> torch.Tensor:
        parts, t = [], start
        while t < start + n:
            c, i = divmod(t, segment)
            keys = keys_of(c)
            m = min(start + n - t, keys.shape[0] - i)
            parts.append(np.asarray(normals(keys[i:i + m]), dtype=np.float64))
            t += m
        z = np.concatenate(parts)
        if rotation is not None:
            z = rotation[None] @ z
        return torch.from_numpy(z)

    return draw


def _w_noise_rotation(jtraining, basis, cost, discretisation):
    """The spectral tier's W-space draws eps as the U-space normals z with
    ``q_noise^T z = eps``, ``q_noise`` as the port's tier forms it from the
    JAX package's own factors (``training.py:_train_pls_loop``)."""
    sigma, q_in, q_out, b_rot, e_const = (
        np.asarray(a, dtype=np.float64)
        for a in jtraining.spectral_system_host(basis, cost, discretisation))
    if discretisation == "preconditioned":
        q_noise = np.sqrt(np.asarray(basis.eigenvalues, dtype=np.float64))[:, None] * q_in
    elif hasattr(basis, "noise_factor"):
        q_noise = np.asarray(basis.noise_factor, dtype=np.float64).T @ q_in
    else:
        q_noise = q_in
    return np.linalg.inv(q_noise.T)


class Carrier:
    """Records every PLS draw of a JAX main and feeds it to the port's main.

    :meth:`record_jax` wraps, for the JAX main's run: the trainer's
    ``train_pls`` (each call's key, steps, step size, tier and
    discretisation, its initial and final particles and energies; for the
    spectral tier the rotation of its W-space draws), ``PLS.initialise_particles``,
    the bases' ``sample_predictive_noise`` (the extra predictive noise
    included) and the costs' ``sample_observation_noise``. :meth:`carry_port`
    wraps the port's counterparts for a run of the port's main: each takes
    the next recorded JAX draw of its kind in order (the port's own draw is
    made and replaced, so its shape and dtype are checked), and each
    ``train_pls`` call runs on the JAX call's normals of every step through
    ``_train_pls_loop(noise=NoiseChunks(...))``, after checking that its
    steps, step size, seed, tier and discretisation are the JAX call's.
    Both keep each ``train_pls_runner`` return (particles, step size,
    steps) of the mains' modules they are given in ``runners``.
    :meth:`drained` checks that the port's main took every draw."""

    KINDS = ("train", "init", "predictive", "observation")

    def __init__(self, start_rtol=1e-7):
        # each port call's initial particles against the JAX call's: carried
        # draws through bases that differ by the GP fits' error (fp32 fits
        # part by more than fp64's 1e-8)
        self.start_rtol = start_rtol
        self.jax = {k: [] for k in self.KINDS}
        self.port_train = []
        self.runners = {"jax": [], "port": []}
        self._muted = False

    def record_jax(self, mp, runner_modules):
        from experiments import trainers as jtrainers
        from projected_langevin_sampling_tpu import training as jtraining
        from projected_langevin_sampling_tpu.models import pls as jpls
        from projected_langevin_sampling_tpu.models.basis import inducing_point as jipb
        from projected_langevin_sampling_tpu.models.basis import orthonormal as jonb
        from projected_langevin_sampling_tpu.models.costs import base as jcost_base

        original_train = jtrainers._train_pls

        def train(pls, particles, number_of_epochs, step_size, early_stopper_patience,
                  seed, fast_path="auto", discretisation="euler"):
            basis, cost = pls.basis, pls.cost
            if jtraining.needs_w_space_reroute(basis, fast_path, discretisation):
                basis = jtraining.ipb_w_space_view(basis)[0]
            tier = jtraining.resolve_tier(basis, cost, fast_path, discretisation,
                                          particles_bytes=particles.dtype.itemsize * particles.size)
            tier = {"spectral_fused": "spectral"}.get(tier, tier)
            rotation = (_w_noise_rotation(jtraining, basis, cost, discretisation)
                        if tier == "spectral" else None)
            out, energies = original_train(
                pls=pls, particles=particles, number_of_epochs=number_of_epochs,
                step_size=step_size, early_stopper_patience=early_stopper_patience, seed=seed,
                fast_path=fast_path, discretisation=discretisation)
            self.jax["train"].append(dict(
                seed=seed, steps=int(number_of_epochs), step_size=float(step_size), tier=tier,
                discretisation=discretisation, dtype=particles.dtype, rotation=rotation,
                shape=(basis.approximation_dimension, particles.shape[1]),
                particles_in=to_np(particles), particles=to_np(out), energies=list(energies)))
            return out, energies

        mp.setattr(jtrainers, "_train_pls", train)
        for module in runner_modules:
            self._record_runner(mp, module, "jax")
        self._record(mp, jpls.PLS, "initialise_particles", "init")
        self._record(mp, jonb.OrthonormalBasis, "sample_predictive_noise", "predictive")
        self._record(mp, jipb.InducingPointBasis, "sample_predictive_noise", "predictive")
        self._record(mp, jcost_base.PLSCostMixin, "sample_observation_noise", "observation")

    def _record_runner(self, mp, module, package):
        """Keep each ``module.train_pls_runner`` return in
        ``runners[package]``. A JAX runner that searches on the final energy
        ("loss") runs muted: its train-split predictions are read by
        nothing, and the port's search does not make them
        (experiments_torch/runners.py:_search_metric)."""
        if not hasattr(module, "train_pls_runner"):
            return
        fn = module.train_pls_runner
        signature = inspect.signature(fn)

        def runner(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            unread = package == "jax" and bound.arguments["metric_to_optimise"] == "loss"
            before, self._muted = self._muted, self._muted or unread
            try:
                out = fn(*args, **kwargs)
            finally:
                self._muted = before
            self.runners[package].append(out)
            return out

        mp.setattr(module, "train_pls_runner", runner)

    def _record(self, mp, cls, name, kind):
        original = getattr(cls, name)

        def wrapper(obj, *args, **kwargs):
            out = original(obj, *args, **kwargs)
            if not self._muted:
                self.jax[kind].append(to_np(out))
            return out

        mp.setattr(cls, name, wrapper)

    def carry_port(self, mp, runner_modules):
        from experiments_torch import trainers as ttrainers
        from projected_langevin_sampling_torch import training as ttraining
        from projected_langevin_sampling_torch.models import pls as tpls
        from projected_langevin_sampling_torch.models.basis import inducing_point as tipb
        from projected_langevin_sampling_torch.models.basis import orthonormal as tonb
        from projected_langevin_sampling_torch.models.costs import base as tcost_base
        from projected_langevin_sampling_torch.utils.early_stopper import NoiseChunks

        queues = {k: list(v) for k, v in self.jax.items()}
        self.queues = queues
        current = []
        original_train, original_loop = ttrainers._train_pls, ttraining._train_pls_loop

        def train(pls, particles, number_of_epochs, step_size, early_stopper_patience,
                  seed, fast_path="auto", discretisation="euler"):
            rec = queues["train"].pop(0)
            got = (int(number_of_epochs), float(step_size), seed, discretisation)
            want = (rec["steps"], rec["step_size"], rec["seed"], rec["discretisation"])
            assert got == want, f"the port's train_pls call {got} is not the JAX main's {want}"
            start = rec["particles_in"]
            np.testing.assert_allclose(to_np(particles), start, rtol=self.start_rtol,
                                       atol=self.start_rtol * np.abs(start).max())
            current.append(rec)
            out, energies = original_train(
                pls=pls, particles=particles, number_of_epochs=number_of_epochs,
                step_size=step_size, early_stopper_patience=early_stopper_patience, seed=seed,
                fast_path=fast_path, discretisation=discretisation)
            self.port_train.append(dict(particles=to_np(out), energies=list(energies)))
            return out, energies

        def loop(basis, cost, particles, step_size, patience, number_of_epochs, tier, *args,
                 **kwargs):
            rec = current.pop()
            assert tier == rec["tier"], f"the port runs the {tier} tier, JAX the {rec['tier']}"
            assert tuple(particles.shape) == rec["shape"]
            m, j = rec["shape"]
            draw = jax_run_normals(jax.random.key(rec["seed"]), number_of_epochs, rec["shape"],
                                   rec["dtype"], rec["rotation"])
            kwargs["noise"] = NoiseChunks(
                lambda s, n: draw(s, n).to(particles.dtype), number_of_epochs,
                chunk_steps=max(1, 2**22 // (m * j)))
            return original_loop(basis, cost, particles, step_size, patience, number_of_epochs,
                                 tier, *args, **kwargs)

        mp.setattr(ttrainers, "_train_pls", train)
        mp.setattr(ttraining, "_train_pls_loop", loop)
        for module in runner_modules:
            self._record_runner(mp, module, "port")
        if hasattr(self, "_port_init"):
            mp.setattr(self._port_init[0], "generate_init_particles", self._port_init[1])
        for module, name, port_build in getattr(self, "_port_bases", []):
            mp.setattr(module, name, port_build)
        self._replay(mp, tpls.PLS, "initialise_particles", "init")
        self._replay(mp, tonb.OrthonormalBasis, "sample_predictive_noise", "predictive")
        self._replay(mp, tipb.InducingPointBasis, "sample_predictive_noise", "predictive")
        self._replay(mp, tcost_base.PLSCostMixin, "sample_observation_noise", "observation")

    def _replay(self, mp, cls, name, kind):
        original = getattr(cls, name)

        def wrapper(obj, *args, **kwargs):
            own = original(obj, *args, **kwargs)
            if self._muted:
                return own
            value = self.queues[kind].pop(0)
            n = len(self.jax[kind]) - len(self.queues[kind])
            assert tuple(own.shape) == value.shape, (
                f"the port's draw {n} of kind {kind} has shape {tuple(own.shape)}, "
                f"the JAX main's {value.shape}")
            return torch.as_tensor(value, dtype=own.dtype, device=own.device)

        mp.setattr(cls, name, wrapper)

    def mute(self, mp, module, name):
        """Leave the draws of ``module.name`` out: the JAX main's plot
        runners, which the tests replace, and the port's counterparts,
        whose predictions go only into plots."""
        if not hasattr(module, name):
            return
        fn = getattr(module, name)

        def muted(*args, **kwargs):
            before, self._muted = self._muted, True
            try:
                return fn(*args, **kwargs)
            finally:
                self._muted = before

        mp.setattr(module, name, muted)

    def carry_init_normals(self, mp, jmodule, tmodule):
        """The mixture main's initial normals: ``generate_init_particles``
        draws its (M_k, J) normals from the key ``pls.seed`` in the JAX main
        and takes them as ``normals`` in the port's."""
        jgenerate, tgenerate = jmodule.generate_init_particles, tmodule.generate_init_particles
        kept = self.jax.setdefault("init_normals", [])

        def jax_generate(*args, key=0, **kwargs):
            shape = (kwargs["approximation_dimension"], kwargs["number_of_particles"])
            kept.append(to_np(jax.random.normal(jax.random.key(key), shape,
                                                dtype=kwargs["basis_eigenvalues"].dtype)))
            return jgenerate(*args, key=key, **kwargs)

        def port_generate(*args, **kwargs):
            kwargs["normals"] = torch.from_numpy(self.queues["init_normals"].pop(0))
            return tgenerate(*args, **kwargs)

        mp.setattr(jmodule, "generate_init_particles", jax_generate)
        self._port_init = (tmodule, port_generate)

    def assert_runs_match(self, rtol=1e-7):
        """Every port train_pls call gave its JAX call's energies and
        particles at ``rtol``, and every port ``train_pls_runner`` its JAX
        runner's step size and steps run and its particles at ``rtol``
        (particles with an atol of rtol times the largest)."""
        assert len(self.port_train) == len(self.jax["train"]) > 0
        for i, (jrun, trun) in enumerate(zip(self.jax["train"], self.port_train)):
            assert len(trun["energies"]) == len(jrun["energies"]), i
            np.testing.assert_allclose(trun["energies"], jrun["energies"], rtol=rtol,
                                       err_msg=f"train_pls call {i}")
            np.testing.assert_allclose(trun["particles"], jrun["particles"], rtol=rtol,
                                       atol=rtol * np.abs(jrun["particles"]).max(),
                                       err_msg=f"train_pls call {i}")
        assert len(self.runners["port"]) == len(self.runners["jax"]) > 0
        for i, ((jp, jlr, jn), (tp, tlr, tn)) in enumerate(
                zip(self.runners["jax"], self.runners["port"])):
            assert (tlr, tn) == (jlr, jn), f"train_pls_runner {i}"
            np.testing.assert_allclose(to_np(tp), to_np(jp), rtol=rtol,
                                       atol=rtol * np.abs(to_np(jp)).max(),
                                       err_msg=f"train_pls_runner {i}")

    def carry_bases(self, mp, jmodule, tmodule):
        """The JAX main's bases in the port's main: each
        ``build_orthonormal_basis`` or ``build_inducing_point_basis`` call of
        ``tmodule`` returns the JAX main's basis of the same call, carried
        across (fp64). Takes the GP fits' differences out of a comparison."""
        for name, params, from_numpy in (
                ("build_orthonormal_basis", basis_params, convert.orthonormal_basis_from_numpy),
                ("build_inducing_point_basis", ipb_params,
                 convert.inducing_point_basis_from_numpy)):
            if not hasattr(jmodule, name):
                continue
            kept = self.jax.setdefault(name, [])

            def jax_build(*args, _fn=getattr(jmodule, name), _kept=kept, _params=params,
                          **kwargs):
                out = _fn(*args, **kwargs)
                _kept.append(_params(out))
                return out

            def port_build(*args, _fn=getattr(tmodule, name), _name=name,
                           _from_numpy=from_numpy, **kwargs):
                own = _fn(*args, **kwargs)
                carried = _from_numpy(self.queues[_name].pop(0), device=own.device)
                return carried.replace(
                    additional_predictive_noise_distribution=getattr(
                        own, "additional_predictive_noise_distribution", None))

            mp.setattr(jmodule, name, jax_build)
            self._port_bases = getattr(self, "_port_bases", []) + [(tmodule, name, port_build)]

    def drained(self):
        left = {k: len(v) for k, v in self.queues.items() if v}
        assert not left, f"JAX draws the port's main never took: {left}"


def drop_pls_checkpoints(top):
    """Remove the PLS checkpoints under a main's outputs ``top``: a rerun
    of the main reloads its GP and SVGP fits and trains only PLS."""
    for d, _, files in os.walk(top):
        for f in files:
            if f.startswith("pls") and f.endswith(".pkl"):
                os.remove(os.path.join(d, f))
