"""The port's baseline GPs against the JAX package (CPU, fp64): likelihoods,
``ExactGP``, ``SVGP``, ``titsias_optimal_svgp`` and the Dirichlet targets at
rtol 1e-10; ``fit_exact_gp`` and ``fit_svgp`` against the JAX fits over 20
epochs at rtol 1e-8, with the SVGP's per-epoch permutations taken from the
JAX key schedule and injected; both stoppers and the ``(None, None)`` case.
The SVGP's split into its kernel side (``project``) and the marginals, and
the count of fits that evaluate their kernel side once, are the port's own.

Values that can sit near 0 are compared with an absolute floor of 1e-12
times the largest magnitude of the JAX value (normwise), as the other
parity tests of the port do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_torch.models.gaussian_process import (
    init_svgp,
    titsias_optimal_svgp,
)
from projected_langevin_sampling_torch.models.gaussian_process import training as ttrain
from projected_langevin_sampling_torch.models.gaussian_process.dirichlet import (
    dirichlet_classification_targets as t_dirichlet,
)
from projected_langevin_sampling_tpu.models import gaussian_process as jgp
from projected_langevin_sampling_tpu.models.gaussian_process import training as jtrain
from projected_langevin_sampling_tpu.models.gaussian_process.dirichlet import (
    dirichlet_classification_targets as j_dirichlet,
)
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import (
    CPU,
    exact_gp_params,
    gp_data,
    gp_jax_kernel,
    jax_svgp,
    kernel_params,
    likelihood_params,
    svgp_params,
    to_np,
)

RTOL = 1e-10
FIT_RTOL = 1e-8
EPOCHS = 20


def _close(got, expected, rtol=RTOL):
    expected = np.asarray(expected)
    atol = 1e-12 * float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(to_np(got), expected, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# likelihoods, ExactGP, SVGP, Titsias, Dirichlet
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["gaussian", "bernoulli", "student_t"])
def test_likelihoods_match_jax(kind):
    rng = np.random.default_rng(1)
    mean_f, var_f = rng.normal(size=25), rng.uniform(0.01, 0.5, 25)
    y = (rng.uniform(size=25) > 0.5).astype(np.float64) if kind == "bernoulli" else rng.normal(
        size=25)
    jl = jax_svgp(kind)[0].likelihood
    tl = convert.likelihood_from_numpy(likelihood_params(jl), device=CPU)
    args = [jnp.asarray(a) for a in (y, mean_f, var_f)]
    targs = [torch.as_tensor(a) for a in (y, mean_f, var_f)]
    _close(tl.expected_log_prob(*targs), jl.expected_log_prob(*args))
    # the quadrature's (N, Q) latent values; the Gaussian takes one per point
    f2 = rng.normal(size=(25,) if kind == "gaussian" else (25, 3))
    _close(tl.log_prob(targs[0], torch.as_tensor(f2)), jl.log_prob(args[0], jnp.asarray(f2)))
    j_marg, t_marg = jl.marginal(*args[1:]), tl.marginal(*targs[1:])
    assert type(t_marg).__name__ == type(j_marg).__name__
    _close(t_marg.mean, j_marg.mean)
    if kind != "bernoulli":
        _close(t_marg.variance, j_marg.variance)
        _close(t_marg.negative_log_likelihood(targs[0]),
               j_marg.negative_log_likelihood(args[0]))


@pytest.mark.parametrize("fixed_noise", [False, True], ids=["learned", "fixed"])
def test_exact_gp_matches_jax(fixed_noise):
    x, y = gp_data(d=2)
    x[7] = x[3]  # an exact duplicate row: the same-input gram keeps K + noise PD
    fixed = np.random.default_rng(2).uniform(0.01, 0.1, 30) if fixed_noise else None
    jgp_ = jgp.ExactGP(mean_constant=jnp.asarray(0.3), kernel=gp_jax_kernel(2),
                       noise=jnp.asarray(0.05), x_train=jnp.asarray(x), y_train=jnp.asarray(y),
                       fixed_noise_variances=None if fixed is None else jnp.asarray(fixed))
    tgp = convert.exact_gp_from_numpy(exact_gp_params(jgp_), device=CPU)
    _close(tgp.log_marginal_likelihood(), jgp_.log_marginal_likelihood())
    _close(tgp.prior(torch.as_tensor(x))[1], jgp_.prior(jnp.asarray(x))[1])
    x_test = np.random.default_rng(3).uniform(-2.5, 2.5, (12, 2))
    for name in ("predict_f", "predict_y"):
        t_pred = getattr(tgp, name)(torch.as_tensor(x_test))
        j_pred = getattr(jgp_, name)(jnp.asarray(x_test))
        _close(t_pred.mean, j_pred.mean)
        _close(t_pred.variance, j_pred.variance)


@pytest.mark.parametrize("kind,pls", [("gaussian", False), ("gaussian", True),
                                      ("bernoulli", False), ("student_t", True)])
def test_svgp_matches_jax(kind, pls):
    jsvgp, x, y = jax_svgp(kind, pls=pls)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    j_lat, t_lat = jsvgp.latent(jnp.asarray(x)), tsvgp.latent(tx)
    _close(t_lat.mean, j_lat.mean)
    _close(t_lat.variance, j_lat.variance)
    _close(tsvgp.kl_divergence(), jsvgp.kl_divergence())
    _close(tsvgp.elbo(tx[:10], ty[:10], 30), jsvgp.elbo(jnp.asarray(x[:10]), jnp.asarray(y[:10]),
                                                         30))
    _close(tsvgp.predict_y(tx).mean, jsvgp.predict_y(jnp.asarray(x)).mean)


@pytest.mark.parametrize("pls", [False, True], ids=["ard", "pls"])
def test_latent_is_the_marginals_of_the_projection(pls):
    """``latent(x)`` is the mean-and-variance step on ``project(x)``, bit for
    bit; the rows of a projection of all the data, gathered by an index, are
    the projection of those rows (rtol 1e-13: a solve over more rows may round
    a last bit apart)."""
    jsvgp, x, _ = jax_svgp("gaussian", pls=pls, d=2)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    tx = torch.as_tensor(x)
    latent, split = tsvgp.latent(tx), tsvgp.latent(tsvgp.project(tx))
    for got, want in ((split.mean, latent.mean), (split.variance, latent.variance)):
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    index = torch.as_tensor(np.random.default_rng(4).permutation(len(x))[:11])
    rows, own = tsvgp.project(tx)[index], tsvgp.project(tx[index])
    assert len(rows) == len(own) == 11
    np.testing.assert_allclose(to_np(rows.a), to_np(own.a), rtol=1e-13, atol=0)
    np.testing.assert_allclose(to_np(rows.k_diag), to_np(own.k_diag), rtol=1e-13, atol=0)


@pytest.mark.parametrize("pls", [False, True], ids=["ard", "pls"])
def test_init_and_titsias_optimal_svgp_match_jax(pls):
    jsvgp, x, y = jax_svgp("gaussian", pls=pls, fitted=False)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    t_fresh = init_svgp(0.2, tsvgp.kernel, tsvgp.likelihood, torch.as_tensor(x[:6]))
    _close(t_fresh.variational_chol, jsvgp.variational_chol)
    assert float(t_fresh.kl_divergence()) == 0.0
    j_opt = jgp.titsias_optimal_svgp(jsvgp, jnp.asarray(x), jnp.asarray(y))
    t_opt = titsias_optimal_svgp(tsvgp, torch.as_tensor(x), torch.as_tensor(y))
    _close(t_opt.variational_mean, j_opt.variational_mean)
    _close(t_opt.variational_chol, j_opt.variational_chol)
    _close(t_opt.elbo(torch.as_tensor(x), torch.as_tensor(y), 30),
           j_opt.elbo(jnp.asarray(x), jnp.asarray(y), 30))


@pytest.mark.parametrize("labels", [np.array([0, 2, 1, 1, 0, 2, 2]), np.array([0., 1., 1., 0.])],
                         ids=["int", "float"])
def test_dirichlet_targets_match_jax(labels):
    jt, js, jc = j_dirichlet(jnp.asarray(labels))
    tt, ts, tc = t_dirichlet(torch.as_tensor(labels), device=CPU)
    assert tc == jc
    assert tt.dtype == (torch.float32 if labels.dtype.kind == "i" else torch.float64)
    _close(tt, jt)
    _close(ts, js)


# --------------------------------------------------------------------------
# the fits
# --------------------------------------------------------------------------
def _tkernel(jkernel):
    return convert.ard_kernel_from_numpy(kernel_params(jkernel), device=CPU)


@pytest.mark.parametrize("fixed_noise", [False, True], ids=["learned", "fixed"])
def test_fit_exact_gp_matches_jax(fixed_noise):
    x, y = gp_data(d=2)
    fixed = np.random.default_rng(2).uniform(0.01, 0.1, 30) if fixed_noise else None
    kw = dict(noise=0.1, mean_constant=0.1, learning_rate=0.05, number_of_epochs=EPOCHS,
              fixed_noise_variances=fixed)
    j_gp, j_losses = jtrain.fit_exact_gp(jnp.asarray(x), jnp.asarray(y), gp_jax_kernel(2), **kw)
    t_gp, t_losses = ttrain.fit_exact_gp(torch.as_tensor(x), torch.as_tensor(y),
                                         _tkernel(gp_jax_kernel(2)), **kw)
    assert len(t_losses) == len(j_losses) == EPOCHS and t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=FIT_RTOL)
    for name in ("mean_constant", "noise"):
        _close(getattr(t_gp, name), getattr(j_gp, name), rtol=FIT_RTOL)
    _close(t_gp.kernel.lengthscales, j_gp.kernel.lengthscales, rtol=FIT_RTOL)
    _close(t_gp.kernel.outputscale, j_gp.kernel.outputscale, rtol=FIT_RTOL)
    assert not t_gp.kernel.lengthscales.requires_grad


def _jax_orders(seed, n, epochs):
    """The per-epoch permutations of the JAX ``fit_svgp`` scan."""
    key, orders = as_key(seed), []
    for _ in range(epochs):
        key, shuffle_key = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(shuffle_key, n)))
    return np.stack(orders)


def _fit_both(jsvgp, x, y, epochs=EPOCHS, seed=3, **kw):
    j_fit, j_losses = jtrain.fit_svgp(jsvgp, jnp.asarray(x), jnp.asarray(y), epochs, key=seed,
                                      **kw)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    t_fit, t_losses = ttrain.fit_svgp(tsvgp, torch.as_tensor(x), torch.as_tensor(y), epochs,
                                      orders=_jax_orders(seed, len(y), epochs), **kw)
    return j_fit, j_losses, t_fit, t_losses


def _close_svgp(t_fit, j_fit, rtol=FIT_RTOL):
    for name in ("mean_constant", "variational_mean", "variational_chol", "x_induce"):
        _close(getattr(t_fit, name), getattr(j_fit, name), rtol=rtol)
    t_ard = t_fit.kernel.base_kernel if hasattr(t_fit.kernel, "base_kernel") else t_fit.kernel
    j_ard = j_fit.kernel.base_kernel if hasattr(j_fit.kernel, "base_kernel") else j_fit.kernel
    _close(t_ard.lengthscales, j_ard.lengthscales, rtol=rtol)
    _close(t_ard.outputscale, j_ard.outputscale, rtol=rtol)
    if hasattr(j_fit.likelihood, "noise"):
        _close(t_fit.likelihood.noise, j_fit.likelihood.noise, rtol=rtol)


@pytest.mark.parametrize("case", ["free", "frozen_pls", "inducing_bernoulli"])
def test_fit_svgp_matches_jax(case):
    if case == "free":
        jsvgp, x, y = jax_svgp("gaussian", fitted=False)
        kw = dict(batch_size=8, learning_rate=0.1)  # 3 batches and a remainder of 6
    elif case == "frozen_pls":
        jsvgp, x, y = jax_svgp("student_t", pls=True, fitted=False)
        kw = dict(batch_size=10, learning_rate=0.1, learn_kernel_parameters=False,
                  learn_observation_noise=False)
    else:
        jsvgp, x, y = jax_svgp("bernoulli", fitted=False)
        kw = dict(batch_size=7, learning_rate=0.2, learn_inducing_locations=True)
    j_fit, j_losses, t_fit, t_losses = _fit_both(jsvgp, x, y, **kw)
    assert len(t_losses) == len(j_losses) == EPOCHS and t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=FIT_RTOL)
    _close_svgp(t_fit, j_fit)
    t_ard = t_fit.kernel.base_kernel if case == "frozen_pls" else t_fit.kernel
    moved = not torch.equal(t_ard.lengthscales, torch.as_tensor(np.asarray(
        (jsvgp.kernel.base_kernel if case == "frozen_pls" else jsvgp.kernel).lengthscales)))
    assert moved == (case != "frozen_pls")


@pytest.mark.parametrize("case", ["free", "frozen", "inducing"])
def test_fit_svgp_counts_the_fits_that_evaluate_their_kernel_once(case):
    """``fit_svgp.fits`` counts every fit; ``fit_svgp.kernel_once`` only one
    that learns neither the kernel nor the inducing inputs."""
    jsvgp, x, y = jax_svgp("gaussian", pls=True, fitted=False)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    kw = {"free": {}, "frozen": dict(learn_kernel_parameters=False),
          "inducing": dict(learn_kernel_parameters=False, learn_inducing_locations=True)}[case]
    before = ttrain.fit_svgp.fits, ttrain.fit_svgp.kernel_once
    fit, losses = ttrain.fit_svgp(tsvgp, torch.as_tensor(x), torch.as_tensor(y), 2,
                                  batch_size=8, learning_rate=0.1, generator=1, **kw)
    assert fit is not None and len(losses) == 2
    assert ttrain.fit_svgp.fits == before[0] + 1
    assert ttrain.fit_svgp.kernel_once == before[1] + (case == "frozen")


def test_fit_svgp_counts_on_itself_when_its_name_is_rebound(monkeypatch):
    """A wrapper put in the module's place (as a planted fault is) still
    reaches the counters on the function it wraps."""
    fit = ttrain.fit_svgp
    monkeypatch.setattr(ttrain, "fit_svgp", lambda *a, **k: fit(*a, **k))
    jsvgp, x, y = jax_svgp("gaussian", fitted=False)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    before = fit.fits, fit.kernel_once
    ttrain.fit_svgp(tsvgp, torch.as_tensor(x), torch.as_tensor(y), 1, batch_size=8,
                    learning_rate=0.1, learn_kernel_parameters=False, generator=1)
    assert (fit.fits, fit.kernel_once) == (before[0] + 1, before[1] + 1)


def test_exact_gp_stopper_discards_the_stopping_update():
    """Patience 0 at a large step: the fit stops at its first epoch without
    improvement, keeps the parameters from before that epoch's update, and
    does not record its loss; the JAX fit does the same."""
    x, y = gp_data(d=2)
    kw = dict(noise=0.1, learning_rate=0.8, number_of_epochs=EPOCHS, early_stopper_patience=0.0)
    j_gp, j_losses = jtrain.fit_exact_gp(jnp.asarray(x), jnp.asarray(y), gp_jax_kernel(2), **kw)
    t_gp, t_losses = ttrain.fit_exact_gp(torch.as_tensor(x), torch.as_tensor(y),
                                         _tkernel(gp_jax_kernel(2)), **kw)
    assert 0 < len(t_losses) < EPOCHS and len(t_losses) == len(j_losses)
    np.testing.assert_allclose(t_losses, j_losses, rtol=FIT_RTOL)
    _close(t_gp.kernel.lengthscales, j_gp.kernel.lengthscales, rtol=FIT_RTOL)
    # the kept parameters give the last recorded loss's successor, not the
    # stopping epoch's update: refitting for len(losses) epochs lands there
    t_short, _ = ttrain.fit_exact_gp(torch.as_tensor(x), torch.as_tensor(y), _tkernel(gp_jax_kernel(2)),
                                     **{**kw, "number_of_epochs": len(t_losses),
                                        "early_stopper_patience": float("inf")})
    _close(t_gp.kernel.lengthscales, to_np(t_short.kernel.lengthscales), rtol=1e-14)


def test_svgp_stopper_adopts_the_stopping_update():
    jsvgp, x, y = jax_svgp("gaussian", fitted=False)
    kw = dict(batch_size=8, learning_rate=2.0, early_stopper_patience=0.0)
    j_fit, j_losses, t_fit, t_losses = _fit_both(jsvgp, x, y, **kw)
    assert 0 < len(t_losses) < EPOCHS and len(t_losses) == len(j_losses)
    np.testing.assert_allclose(t_losses, j_losses, rtol=FIT_RTOL)
    _close_svgp(t_fit, j_fit)
    # adopted: the result is one epoch past a fit of len(losses) epochs
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    orders = _jax_orders(3, 30, EPOCHS)
    t_short, _ = ttrain.fit_svgp(tsvgp, torch.as_tensor(x), torch.as_tensor(y), len(t_losses) + 1,
                                 orders=orders, batch_size=8, learning_rate=2.0)
    _close(t_fit.variational_mean, to_np(t_short.variational_mean), rtol=1e-14)


def test_fit_svgp_returns_none_on_non_finite_parameters():
    jsvgp, x, y = jax_svgp("gaussian", fitted=False)
    kw = dict(batch_size=8, learning_rate=1e6)
    j_fit, j_losses, t_fit, t_losses = _fit_both(jsvgp, x, y, epochs=3, **kw)
    assert j_fit is None and j_losses is None
    assert t_fit is None and t_losses is None


def test_fit_svgp_draws_its_own_permutations():
    """Without injected orders the permutations come from the generator: the
    same seed gives the same fit, another seed another."""
    jsvgp, x, y = jax_svgp("gaussian", fitted=False)
    tsvgp = convert.svgp_from_numpy(svgp_params(jsvgp), device=CPU)
    fit = lambda seed: ttrain.fit_svgp(tsvgp, torch.as_tensor(x), torch.as_tensor(y), 3,  # noqa
                                       batch_size=8, learning_rate=0.1, generator=seed)[1]
    assert fit(1) == fit(1) and fit(1) != fit(2)
