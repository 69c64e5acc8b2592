"""GP baseline trainers (counterpart of
``projected_langevin_sampling_tpu/models/gaussian_process/training.py``; the
reference's ``experiments/trainers.py:15-136``): Adam on the exact MLL, SGD
on the minibatched variational ELBO, with optional frozen kernel and noise
parameters.

Each fit is one run of ``utils/early_stopper.run_training``, the counterpart
of the JAX package's jitted ``lax.scan`` with the stopper as scan state: on
the card one epoch (the exact GP's step, or the SVGP's minibatch steps, its
remainder batch and its full-data loss) is captured into a CUDA graph and
replayed, and the host reads the stop flag once a chunk of epochs, as the
JAX ``_drain_chunks`` does; on the CPU the same epoch runs eagerly. Positive
parameters (lengthscales, outputscale, noise) are fitted in log-space, and
both losses are per data point, as gpytorch's. On the card every gram and
its gradient go through B2 (``ops/cuda/gram.py``). Each trainer keeps its
reference's stopper exactly: the exact-GP stopper discards the stopping
epoch's update (``trainers.py:36-44``), the SVGP stopper adopts it
(``:117-130``), neither records the stopping loss, and non-finite SVGP
parameters return ``(None, None)`` (``:131-134``). Adam and SGD are optax's
updates written as tensor ops, so the optimiser state is part of the run's
state and a discarded update drops it with ``torch.where``. Under the
profiler a fit is the span ``pls.fit_exact_gp`` or ``pls.fit_svgp``, and its
read-back of the losses and rebuild of the model ``pls.fit.readback``
(``utils/tracing.span``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from projected_langevin_sampling_torch.models.gaussian_process.exact_gp import ExactGP
from projected_langevin_sampling_torch.models.gaussian_process.svgp import SVGP
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel, _as_2d
from projected_langevin_sampling_torch.ops.linalg import (
    _all_finite,
    _cholesky_or_nan,
    ladder_cholesky,
)
from projected_langevin_sampling_torch.utils.device import as_tensor
from projected_langevin_sampling_torch.utils.early_stopper import run_training, take
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator
from projected_langevin_sampling_torch.utils.tracing import span

# optax.adam's defaults (b1, b2, eps; eps_root 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _recorded_losses(run) -> list[float]:
    return [float(e) for e, r in zip(run.energies.tolist(), run.recorded.tolist()) if r]


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


def _detached(params: dict) -> dict:
    return {name: v.detach() for name, v in params.items()}


_EXACT_PARAMS = ("mean_constant", "log_lengthscales", "log_outputscale", "log_noise")


def _adam(params, grads, mu, nu, count, learning_rate: float):
    """One step of optax.adam: the moments, their bias corrections at step
    ``count + 1`` and ``p - lr m_hat / (sqrt(v_hat) + eps)``."""
    count = count + 1.0
    mu = tuple((1.0 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, mu))
    nu = tuple((1.0 - ADAM_B2) * g**2 + ADAM_B2 * v for g, v in zip(grads, nu))
    c1, c2 = 1.0 - ADAM_B1**count, 1.0 - ADAM_B2**count
    params = tuple(
        p + (-learning_rate) * ((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
        for p, m, v in zip(params, mu, nu)
    )
    return params, mu, nu, count


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
    ``FixedNoiseGaussianLikelihood(learn_additional_noise=True)``).

    An epoch factors K + noise once. Where that factor is not finite, the
    epoch defers and the rest of the run takes :func:`ladder_cholesky`, the
    escalating jitter of ``nan_rescued_cholesky`` as data flow: the same
    numbers, at the ladder's price only where the plain factor fails."""
    with span("pls.fit_exact_gp"):
        device = kernel.device
        x = _as_2d(as_tensor(x, device=device))
        y = as_tensor(y, device=device)
        dtype = x.dtype
        if fixed_noise_variances is not None:
            fixed_noise_variances = as_tensor(fixed_noise_variances, device=device, dtype=dtype)
        as_param = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
        params = (
            as_param(mean_constant),
            torch.log(as_param(kernel.lengthscales)),
            torch.log(as_param(kernel.outputscale)),
            torch.log(as_param(noise)),
        )
        params = tuple(p.detach().clone().requires_grad_() for p in params)
        n = y.shape[0]

        def epoch(rescue: bool):
            def step(t, state):
                p, mu, nu, count = state[:4], state[4:8], state[8:12], state[12]
                failed = []

                def plain(matrix):
                    chol = _cholesky_or_nan(matrix)
                    failed.append(~_all_finite(chol).all())
                    return chol

                gp = _exact_gp_from_params(dict(zip(_EXACT_PARAMS, p)), x, y, fixed_noise_variances)
                loss = -gp.log_marginal_likelihood(ladder_cholesky if rescue else plain) / n
                grads = torch.autograd.grad(loss, p)
                new_p, mu, nu, count = _adam(p, grads, mu, nu, count, learning_rate)
                new_state = (*new_p, *mu, *nu, count)
                return (new_state, loss) if rescue else (new_state, loss, failed[0])

            return step

        zeros = tuple(torch.zeros_like(p) for p in params)
        run = run_training(
            epoch(rescue=False),
            (*params, *zeros, *zeros, torch.zeros((), dtype=dtype, device=device)),
            int(number_of_epochs), learning_rate, early_stopper_patience, dtype, device,
            discard=True, fallback=epoch(rescue=True), what="fit_exact_gp",
        )
        with span("pls.fit.readback"):
            fitted = {name: v.detach() for name, v in zip(_EXACT_PARAMS, run.state[:4])}
            return (_exact_gp_from_params(fitted, x, y, fixed_noise_variances),
                    _recorded_losses(run))


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


# the parameters that K_zz, its factor and each row's projection depend on
_KERNEL_SIDE = frozenset({"log_lengthscales", "log_outputscale", "x_induce"})


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
    Returns ``(None, None)`` if an epoch leaves a parameter non-finite.

    A fit that learns neither the kernel nor the inducing inputs evaluates
    the kernel side of the ELBO once, before its epochs (the span
    ``pls.fit_svgp.project``): K_zz's factor, and each training row's
    A = K_xz L^{-T} and k(x, x) (a ``Projection``), whose rows each batch
    gathers. A row is the value a batch of its own would compute, up to the
    rounding of a solve over more rows. ``fit_svgp.fits`` counts the fits
    started, ``fit_svgp.kernel_once`` those that took this path.

    On the card the epoch's permutation is drawn inside the graph from
    ``generator``, registered with it, so a graphed fit draws the very
    permutations of the eager one."""
    with span("pls.fit_svgp"):
        device = svgp.x_induce.device
        x = _as_2d(as_tensor(x, device=device))
        y = as_tensor(y, device=device)
        n = x.shape[0]
        batch_size = min(int(batch_size), n)
        num_batches = max(n // batch_size, 1)
        rem = n - num_batches * batch_size
        if orders is None:
            generator = as_generator(generator, device=device)
        else:
            orders = torch.as_tensor(np.asarray(orders), dtype=torch.int64, device=device)

        frozen = set()
        if not learn_kernel_parameters:
            frozen |= {"log_lengthscales", "log_outputscale"}
        if not learn_observation_noise:
            frozen |= {"log_noise"}
        params = _svgp_params(svgp, learn_inducing_locations)
        names = tuple(params)
        trainable = tuple(name for name in names if name not in frozen)

        _counted.fits += 1
        rows = x
        if _KERNEL_SIDE.isdisjoint(trainable):
            # nothing the fit trains reaches K_zz, its factor or a row's
            # projection: evaluate them once, and gather a batch's rows
            _counted.kernel_once += 1
            with span("pls.fit_svgp.project"), torch.no_grad():
                rows = _svgp_from_params(params, svgp).project(x)

        def sgd(p: dict, index: torch.Tensor) -> dict:
            """One optax.sgd step on a batch: p - lr g."""
            p = {k: v.detach().requires_grad_(k in trainable) for k, v in p.items()}
            loss = -_svgp_from_params(p, svgp).elbo(rows[index], y[index], n) / n
            grads = torch.autograd.grad(loss, [p[k] for k in trainable], allow_unused=True)
            for k, g in zip(trainable, grads):
                if g is not None:
                    p[k] = p[k].detach() - learning_rate * g
            return p

        def step(t, state):
            p = dict(zip(names, state))
            if orders is None:
                order = torch.randperm(n, generator=generator, device=device)
            else:
                order = take(orders, t)
            for b in range(num_batches):
                p = sgd(p, order[b * batch_size : (b + 1) * batch_size])
            if rem:
                p = sgd(p, order[num_batches * batch_size :])
            with torch.no_grad():
                p = _detached(p)
                loss = -_svgp_from_params(p, svgp).elbo(rows, y, n) / n
            return tuple(p[k] for k in names), loss

        def non_finite(state):
            return ~torch.stack([torch.isfinite(v).all() for v in state]).all()

        # the epoch's updates are adopted, then non-finite parameters abort,
        # then the stopper may stop without recording the loss
        run = run_training(
            step, tuple(params[k] for k in names), int(number_of_epochs), learning_rate,
            early_stopper_patience, x.dtype, device, abort=non_finite,
            generators=(generator,) if orders is None and device.type == "cuda" else (),
            what="fit_svgp",
        )
        if run.aborted:
            return None, None
        with span("pls.fit.readback"):
            fitted = {k: v.detach() for k, v in zip(names, run.state)}
            return _svgp_from_params(fitted, svgp), _recorded_losses(run)


# counted on the host once a call: the fits started, and those that evaluated
# their kernel side once; on the function itself, whatever later rebinds
# the module's name
fit_svgp.fits = 0
fit_svgp.kernel_once = 0
_counted = fit_svgp
