"""The port's calibration layer against the JAX package (CPU, fp64, rtol
1e-10): ``ConformaliseGP``, ``ConformalisePLS``, ``TemperGP``,
``TemperPLSClassification`` and ``custom_types``.

The PLS classes draw fresh noise each call in both packages (JAX from
``fold_in(key, call)``, the port from one generator). Here both get the same
injected noise: the JAX classes through a test subclass whose sample draw
reads it, the port's through its injection hook (the calibration noise at
construction, the test points' noise at predict), as ``TemperPLS`` is
tested in ``test_torch_slice.py``.
"""

import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_torch.models import custom_types
from projected_langevin_sampling_torch.models.conformalise.base import quantile
from projected_langevin_sampling_tpu.models import gaussian_process as jgp
from projected_langevin_sampling_tpu.models.conformalise import ConformaliseGP as JConfGP
from projected_langevin_sampling_tpu.models.conformalise import ConformalisePLS as JConfPLS
from projected_langevin_sampling_tpu.models.pls import PLS as JPLS
from projected_langevin_sampling_tpu.models.temper import TemperGP as JTemperGP
from projected_langevin_sampling_tpu.models.temper import TemperPLSClassification as JTemperCls
from projected_langevin_sampling_tpu.ops.kernels import ARDKernel
from tests.torch_parity import (
    CPU,
    carried,
    exact_gp_params,
    jax_cost,
    jax_onb,
    jax_svgp,
    svgp_params,
    to_np,
)

RTOL = 1e-10
J = 16


def _close(got, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(to_np(got), expected, rtol=RTOL,
                               atol=1e-12 * float(np.max(np.abs(expected))))


def _split(n_cal=12, n_test=9, seed=0):
    rng = np.random.default_rng(seed)
    x_cal, x_test = rng.uniform(-2, 2, (n_cal, 1)), rng.uniform(-2, 2, (n_test, 1))
    y_cal = np.sin(2 * x_cal[:, 0]) + 0.2 * rng.normal(size=n_cal)
    y_test = np.sin(2 * x_test[:, 0]) + 0.2 * rng.normal(size=n_test)
    return x_cal, y_cal, x_test, y_test


def _gps():
    """(JAX, port) pairs: an exact GP and a Student-T SVGP."""
    x, y = _split(n_cal=30, seed=1)[:2]
    j_exact = jgp.ExactGP(mean_constant=jnp.asarray(0.1),
                          kernel=ARDKernel(jnp.asarray([0.8]), jnp.asarray(1.1)),
                          noise=jnp.asarray(0.05), x_train=jnp.asarray(x), y_train=jnp.asarray(y))
    j_svgp = jax_svgp("student_t")[0]
    return {
        "exact": (j_exact, convert.exact_gp_from_numpy(exact_gp_params(j_exact), device=CPU)),
        "svgp_student_t": (j_svgp, convert.svgp_from_numpy(svgp_params(j_svgp), device=CPU)),
    }


@pytest.mark.parametrize("gp", ["exact", "svgp_student_t"])
def test_conformalise_gp_matches_jax(gp):
    j_model, t_model = _gps()[gp]
    x_cal, y_cal, x_test, _ = _split()
    j_conf = JConfGP(j_model, jnp.asarray(x_cal), jnp.asarray(y_cal))
    t_conf = pt.ConformaliseGP(t_model, torch.as_tensor(x_cal), torch.as_tensor(y_cal))
    for coverage in (0.5, 0.95):
        j_pred = j_conf(jnp.asarray(x_test), coverage)
        t_pred = t_conf(torch.as_tensor(x_test), coverage)
        for name in ("mean", "lower", "upper"):
            _close(getattr(t_pred, name), getattr(j_pred, name))
    _close(t_conf.predict_variance(torch.as_tensor(x_test)),
           j_conf.predict_variance(jnp.asarray(x_test)))
    np.testing.assert_allclose(
        t_conf.calculate_average_interval_width(torch.as_tensor(x_test), 0.9),
        j_conf.calculate_average_interval_width(jnp.asarray(x_test), 0.9), rtol=RTOL)


@pytest.mark.parametrize("gp", ["exact", "svgp_student_t"])
def test_temper_gp_matches_jax(gp):
    j_model, t_model = _gps()[gp]
    x_cal, y_cal, x_test, _ = _split()
    j_temper = JTemperGP(j_model, jnp.asarray(x_cal), jnp.asarray(y_cal))
    t_temper = pt.TemperGP(t_model, torch.as_tensor(x_cal), torch.as_tensor(y_cal))
    np.testing.assert_allclose(t_temper.scale, j_temper.scale, rtol=RTOL)
    j_pred, t_pred = j_temper(jnp.asarray(x_test)), t_temper(torch.as_tensor(x_test))
    _close(t_pred.mean, j_pred.mean)
    _close(t_pred.variance, j_pred.variance)


def _pls_models(cost="gaussian"):
    jbasis, jcost, x, _ = jax_onb()
    if cost != "gaussian":
        jcost = jax_cost(cost, x)
    tbasis, tcost = carried(jbasis, jcost)
    u = np.random.default_rng(2).normal(size=(jbasis.approximation_dimension, J))
    return JPLS(jbasis, jcost), pt.PLS(tbasis, tcost), u


def _noise(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m + n, J)) * 0.3, 0.3 * rng.normal(size=J)


class _InjectedConfPLS(JConfPLS):
    """The JAX ConformalisePLS with its draws read from ``noises``, keyed by
    the number of points."""

    def __init__(self, noises, **kw):
        self.noises = noises
        super().__init__(**kw)

    def _samples(self, x):
        pred, obs = self.noises[x.shape[0]]
        return self.pls.predict_samples(x=x, particles=self.particles,
                                        predictive_noise=jnp.asarray(pred),
                                        observation_noise=jnp.asarray(obs))


def test_conformalise_pls_matches_jax_with_injected_noise():
    j_pls, t_pls, u = _pls_models()
    m = j_pls.basis.approximation_dimension
    x_cal, y_cal, x_test, _ = _split()
    noises = {len(x_cal): _noise(m, len(x_cal), 3), len(x_test): _noise(m, len(x_test), 4)}
    j_conf = _InjectedConfPLS(noises, x_calibration=jnp.asarray(x_cal),
                              y_calibration=jnp.asarray(y_cal), pls=j_pls, particles=jnp.asarray(u))
    cal_pred, cal_obs = noises[len(x_cal)]
    t_conf = pt.ConformalisePLS(torch.as_tensor(x_cal), torch.as_tensor(y_cal), t_pls,
                                torch.as_tensor(u), predictive_noise=torch.as_tensor(cal_pred),
                                observation_noise=torch.as_tensor(cal_obs))
    test_pred, test_obs = noises[len(x_test)]
    noise = {"predictive_noise": torch.as_tensor(test_pred),
             "observation_noise": torch.as_tensor(test_obs)}
    for coverage in (0.5, 0.9):
        j_pred = j_conf(jnp.asarray(x_test), coverage)
        t_pred = t_conf(torch.as_tensor(x_test), coverage, **noise)
        for name in ("mean", "lower", "upper"):
            _close(getattr(t_pred, name), getattr(j_pred, name))
        assert torch.all(t_pred.lower <= t_pred.mean) and torch.all(t_pred.mean <= t_pred.upper)
    _close(t_conf.predict_variance(torch.as_tensor(x_test), **noise),
           j_conf.predict_variance(jnp.asarray(x_test)))


def test_conformalise_pls_draws_fresh_noise_from_its_generator():
    _, t_pls, u = _pls_models()
    x_cal, y_cal, x_test, _ = _split(n_cal=40, n_test=40)
    conf = lambda seed: pt.ConformalisePLS(  # noqa: E731
        torch.as_tensor(x_cal), torch.as_tensor(y_cal), t_pls, torch.as_tensor(u),
        generator=torch.Generator().manual_seed(seed))
    a, b = conf(0), conf(0)
    first = a(torch.as_tensor(x_test), 0.9)
    assert torch.equal(first.lower, b(torch.as_tensor(x_test), 0.9).lower)
    assert not torch.equal(first.lower, a(torch.as_tensor(x_test), 0.9).lower)


class _InjectedTemperCls(JTemperCls):
    def __init__(self, noises, **kw):
        self.noises = noises
        super().__init__(**kw)

    def _latent_samples(self, x):
        return self.pls.predict_untransformed_samples(
            particles=self.particles, x=x, noise=jnp.asarray(self.noises[x.shape[0]]))


def test_temper_pls_classification_matches_jax_with_injected_noise():
    j_pls, t_pls, u = _pls_models("bernoulli")
    m = j_pls.basis.approximation_dimension
    x_cal, _, x_test, _ = _split(n_cal=30)
    y_cal = (np.sin(2 * x_cal[:, 0]) > 0).astype(np.float64)
    noises = {len(x_cal): _noise(m, len(x_cal), 5)[0], len(x_test): _noise(m, len(x_test), 6)[0]}
    j_temper = _InjectedTemperCls(noises, x_calibration=jnp.asarray(x_cal),
                                  y_calibration=jnp.asarray(y_cal), pls=j_pls,
                                  particles=jnp.asarray(u))
    t_temper = pt.TemperPLSClassification(
        torch.as_tensor(x_cal), torch.as_tensor(y_cal), t_pls, torch.as_tensor(u),
        predictive_noise=torch.as_tensor(noises[len(x_cal)]))
    assert t_temper.scale == j_temper.scale
    np.testing.assert_allclose(t_temper.calibration_nll, j_temper.calibration_nll, rtol=RTOL)
    # s = 1 is in the grid: the chosen scale never loses on the calibration split
    f_cal = t_temper._latent_samples(torch.as_tensor(x_cal),
                                     torch.as_tensor(noises[len(x_cal)]))
    from projected_langevin_sampling_torch.models.temper.pls_classification import (
        _bernoulli_nll,
    )
    assert t_temper.calibration_nll <= float(
        _bernoulli_nll(t_temper._tempered_probs(f_cal, 1.0), torch.as_tensor(y_cal)))
    probs = t_temper(torch.as_tensor(x_test),
                     predictive_noise=torch.as_tensor(noises[len(x_test)]))
    _close(probs, j_temper(jnp.asarray(x_test)))
    assert probs.shape == (len(x_test),) and torch.all((probs > 0) & (probs < 1))


@pytest.mark.parametrize("shape,dim", [((37,), 0), ((9, 50), 1), ((4, 1), 1)])
def test_quantile_is_numpy_linear(shape, dim):
    values = torch.as_tensor(np.random.default_rng(8).normal(size=shape))
    for q in (0.0, 0.025, 0.5, 0.9, 0.975, 1.0):
        expected = np.quantile(to_np(values), q, axis=dim)
        np.testing.assert_allclose(to_np(quantile(values, q, dim=dim)), expected, rtol=1e-12,
                                   atol=1e-14)


def test_custom_types_name_the_port_classes():
    assert set(typing.get_args(custom_types.GP_TYPE)) == {pt.ExactGP, pt.SVGP}
    assert set(typing.get_args(custom_types.PLS_TYPE)) == {pt.PLS, pt.ConformalisePLS,
                                                          pt.TemperPLS}
    names = {t.__name__ for t in typing.get_args(custom_types.MODEL_TYPE)}
    assert names == {"ExactGP", "SVGP", "PLS", "TemperBase", "ConformaliseBase"}
