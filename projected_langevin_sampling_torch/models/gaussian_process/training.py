"""GP baseline trainers (counterpart of
``projected_langevin_sampling_tpu/models/gaussian_process/training.py``; the
reference's ``experiments/trainers.py:15-136``): Adam on the exact MLL, SGD
on the minibatched variational ELBO, with optional frozen kernel and noise
parameters.

Eager torch loops, one optimiser step a batch. Positive parameters
(lengthscales, outputscale, noise) are fitted in log-space, and both losses
are per data point, as gpytorch's. On the card every gram and its gradient
go through B2 (``ops/cuda/gram.py``). Each trainer keeps its reference's
stopper exactly: the exact-GP stopper discards the stopping epoch's update
(``trainers.py:36-44``), the SVGP stopper adopts it (``:117-130``), neither
records the stopping loss, and non-finite SVGP parameters return
``(None, None)`` (``:131-134``). The JAX package's ``_drain_chunks`` bounds
the length of a TPU device program and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from projected_langevin_sampling_torch.models.gaussian_process.exact_gp import ExactGP
from projected_langevin_sampling_torch.models.gaussian_process.svgp import SVGP
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel, _as_2d
from projected_langevin_sampling_torch.utils.device import as_tensor
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


class _Stopper:
    """The reference trainers' early stopper on the per-data-point loss:
    stop on a non-finite loss, or once the loss has not improved for
    ``patience`` of simulated time (``learning_rate`` an epoch)."""

    def __init__(self, learning_rate: float, patience: float):
        self.learning_rate = float(learning_rate)
        self.patience = float(patience)
        self.min_loss = math.inf
        self.sim_time = 0.0

    def should_stop(self, loss: float) -> bool:
        improved = loss < self.min_loss
        sim_time = 0.0 if improved else self.sim_time + self.learning_rate
        if not math.isfinite(loss) or (not improved and sim_time >= self.patience):
            return True
        if improved:
            self.min_loss = loss
        self.sim_time = sim_time
        return False


# --------------------------------------------------------------------------
# Exact GP
# --------------------------------------------------------------------------
def _exact_gp_from_params(params, x, y, fixed_noise_variances=None) -> ExactGP:
    return ExactGP(
        mean_constant=params["mean_constant"],
        kernel=ARDKernel(
            lengthscales=torch.exp(params["log_lengthscales"]),
            outputscale=torch.exp(params["log_outputscale"]),
        ),
        noise=torch.exp(params["log_noise"]),
        x_train=x,
        y_train=y,
        fixed_noise_variances=fixed_noise_variances,
    )


def _leaves(values: dict, trainable=lambda name: True) -> dict:
    """Detached copies of ``values``, the trainable ones requiring grad."""
    return {
        name: v.detach().clone().requires_grad_(trainable(name)) for name, v in values.items()
    }


def _detached(params: dict) -> dict:
    return {name: v.detach() for name, v in params.items()}


def fit_exact_gp(
    x,
    y,
    kernel: ARDKernel,
    noise: float = 1.0,
    mean_constant: float = 0.0,
    learning_rate: float = 0.1,
    number_of_epochs: int = 100,
    early_stopper_patience: float = float("inf"),
    fixed_noise_variances=None,
) -> tuple[ExactGP, list[float]]:
    """Adam on the negative exact MLL per data point (reference
    ``trainers.py:15-52``), on the kernel's device. Returns the fitted GP and
    the recorded losses. ``fixed_noise_variances``: per-point noise added to
    the learned scalar (the Dirichlet classification case, gpytorch's
    ``FixedNoiseGaussianLikelihood(learn_additional_noise=True)``)."""
    device = kernel.device
    x = _as_2d(as_tensor(x, device=device))
    y = as_tensor(y, device=device)
    dtype = x.dtype
    if fixed_noise_variances is not None:
        fixed_noise_variances = as_tensor(fixed_noise_variances, device=device, dtype=dtype)
    as_param = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    params = _leaves({
        "mean_constant": as_param(mean_constant),
        "log_lengthscales": torch.log(as_param(kernel.lengthscales)),
        "log_outputscale": torch.log(as_param(kernel.outputscale)),
        "log_noise": torch.log(as_param(noise)),
    })
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)
    stopper = _Stopper(learning_rate, early_stopper_patience)
    losses: list[float] = []
    n = y.shape[0]
    for _ in range(int(number_of_epochs)):
        optimizer.zero_grad()
        gp = _exact_gp_from_params(params, x, y, fixed_noise_variances)
        loss = -gp.log_marginal_likelihood() / n
        loss.backward()
        value = float(loss.detach())
        if stopper.should_stop(value):
            break  # the stopping epoch's update is discarded
        optimizer.step()
        losses.append(value)
    return _exact_gp_from_params(_detached(params), x, y, fixed_noise_variances), losses


# --------------------------------------------------------------------------
# SVGP
# --------------------------------------------------------------------------
def _base_ard(kernel) -> ARDKernel:
    """The ARD leaf of an ARD kernel or of a PLS kernel wrapping one."""
    return kernel.base_kernel if isinstance(kernel, PLSKernel) else kernel


def _rebuild_kernel(template, log_lengthscales, log_outputscale):
    ard = ARDKernel(lengthscales=torch.exp(log_lengthscales), outputscale=torch.exp(log_outputscale))
    if isinstance(template, PLSKernel):
        return dataclasses.replace(template, base_kernel=ard)
    return ard


def _svgp_params(svgp: SVGP, learn_inducing_locations: bool) -> dict:
    ard = _base_ard(svgp.kernel)
    params = {
        "mean_constant": svgp.mean_constant,
        "log_lengthscales": torch.log(ard.lengthscales),
        "log_outputscale": torch.log(ard.outputscale),
        "variational_mean": svgp.variational_mean,
        "variational_chol": svgp.variational_chol,
    }
    if hasattr(svgp.likelihood, "noise"):
        params["log_noise"] = torch.log(svgp.likelihood.noise)
    if learn_inducing_locations:
        params["x_induce"] = svgp.x_induce
    return params


def _svgp_from_params(params: dict, template: SVGP) -> SVGP:
    likelihood = template.likelihood
    if "log_noise" in params:
        likelihood = likelihood.replace(noise=torch.exp(params["log_noise"]))
    return template.replace(
        mean_constant=params["mean_constant"],
        kernel=_rebuild_kernel(
            template.kernel, params["log_lengthscales"], params["log_outputscale"]
        ),
        likelihood=likelihood,
        variational_mean=params["variational_mean"],
        variational_chol=params["variational_chol"],
        x_induce=params.get("x_induce", template.x_induce),
    )


def fit_svgp(
    svgp: SVGP,
    x,
    y,
    number_of_epochs: int,
    batch_size: int,
    learning_rate: float,
    learn_inducing_locations: bool = False,
    learn_kernel_parameters: bool = True,
    learn_observation_noise: bool = True,
    early_stopper_patience: float = float("inf"),
    generator: GeneratorLike = None,
    orders=None,
) -> tuple[SVGP | None, list[float] | None]:
    """SGD on the minibatched negative ELBO per data point (reference
    ``trainers.py:55-136``), on the inducing inputs' device.

    Each epoch visits a fresh permutation of the data in batches of
    ``batch_size`` and then the remainder, as one shorter batch (the
    reference's DataLoader keeps it; so does the JAX package). The
    permutation comes from ``generator``; ``orders`` (epochs, N) injects the
    permutations instead (the parity hook of the tests). The loss recorded
    for an epoch is the full-data loss after its updates.
    ``learn_kernel_parameters=False`` freezes the lengthscales and the
    outputscale, ``learn_observation_noise=False`` the likelihood noise.
    Returns ``(None, None)`` if an epoch leaves a parameter non-finite."""
    device = svgp.x_induce.device
    x = _as_2d(as_tensor(x, device=device))
    y = as_tensor(y, device=device)
    n = x.shape[0]
    batch_size = min(int(batch_size), n)
    num_batches = max(n // batch_size, 1)
    rem = n - num_batches * batch_size
    generator = as_generator(generator, device=device) if orders is None else None

    frozen = set()
    if not learn_kernel_parameters:
        frozen |= {"log_lengthscales", "log_outputscale"}
    if not learn_observation_noise:
        frozen |= {"log_noise"}
    params = _leaves(_svgp_params(svgp, learn_inducing_locations),
                     trainable=lambda name: name not in frozen)
    optimizer = torch.optim.SGD([v for v in params.values() if v.requires_grad],
                                lr=learning_rate)

    def step(index):
        optimizer.zero_grad()
        loss = -_svgp_from_params(params, svgp).elbo(x[index], y[index], n) / n
        loss.backward()
        optimizer.step()

    stopper = _Stopper(learning_rate, early_stopper_patience)
    losses: list[float] = []
    for epoch in range(int(number_of_epochs)):
        if orders is None:
            order = torch.randperm(n, generator=generator, device=device)
        else:
            order = torch.as_tensor(orders[epoch], device=device)
        for b in range(num_batches):
            step(order[b * batch_size : (b + 1) * batch_size])
        if rem:
            step(order[num_batches * batch_size :])
        # the epoch's updates are adopted, then non-finite parameters abort,
        # then the stopper may break without recording the loss
        if not all(bool(torch.isfinite(v).all()) for v in params.values()):
            return None, None
        with torch.no_grad():
            value = float(-_svgp_from_params(params, svgp).elbo(x, y, n) / n)
        if stopper.should_stop(value):
            break
        losses.append(value)
    return _svgp_from_params(_detached(params), svgp), losses
