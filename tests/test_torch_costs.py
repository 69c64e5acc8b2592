"""The non-Gaussian costs and predictive distributions of the PyTorch port
against the JAX package (CPU, fp64), on costs carried across with
``convert``.

Costs, closed-form derivatives and predictive log-densities use the same
formulas in the same order: rtol 1e-12. Autograd derivatives (the probit
link, the mixture, ``force_autograd``) take other paths through the chain
rule in the two frameworks: rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_torch.models import costs as tcosts
from projected_langevin_sampling_torch.models import distributions as tdist
from projected_langevin_sampling_tpu.models import costs as jcosts
from projected_langevin_sampling_tpu.models import distributions as jdist
from tests.torch_parity import carried, carried_cost, jax_cost, jax_onb, to_np

RTOL, RTOL_AUTOGRAD = 1e-12, 1e-10
N, J = 30, 5
COSTS = ["bernoulli", "bernoulli_probit", "smoothed", "poisson", "student_t", "multimodal"]
# the closed form applies to these; the others differentiate by autograd
CLOSED_FORM = {"bernoulli", "smoothed", "poisson", "student_t"}


def _x():
    return np.sort(np.random.default_rng(0).uniform(-2, 2, (N, 1)), axis=0)


def _predictions(name):
    """(N, J) latent values; away from 0 for the Poisson square link."""
    f = np.random.default_rng(3).normal(size=(N, J))
    return f + 2.5 if name == "poisson" else 2.0 * f


def _pair(name):
    jcost = jax_cost(name, _x())
    return jcost, carried_cost(jcost)


@pytest.mark.parametrize("name", COSTS)
def test_cost_matches_jax(name):
    jcost, tcost = _pair(name)
    f = _predictions(name)
    np.testing.assert_allclose(
        to_np(tcost.calculate_cost(torch.as_tensor(f))),
        np.asarray(jcost.calculate_cost(jnp.asarray(f))),
        rtol=RTOL,
    )


@pytest.mark.parametrize("name", COSTS)
def test_cost_derivative_matches_jax(name):
    jcost, tcost = _pair(name)
    f = _predictions(name)
    rtol = RTOL if name in CLOSED_FORM else RTOL_AUTOGRAD
    np.testing.assert_allclose(
        to_np(tcost.calculate_cost_derivative(torch.as_tensor(f))),
        np.asarray(jcost.calculate_cost_derivative(jnp.asarray(f))),
        rtol=rtol, atol=1e-14,
    )
    np.testing.assert_allclose(
        to_np(tcost.calculate_cost_derivative(torch.as_tensor(f), force_autograd=True)),
        np.asarray(jcost.calculate_cost_derivative(jnp.asarray(f), force_autograd=True)),
        rtol=RTOL_AUTOGRAD, atol=1e-14,
    )


@pytest.mark.parametrize("name", COSTS)
def test_predict_matches_jax(name):
    jcost, tcost = _pair(name)
    samples = _predictions(name)
    if name in ("bernoulli", "bernoulli_probit", "smoothed"):
        samples = 1.0 / (1.0 + np.exp(-samples))  # output-space probabilities
    elif name == "poisson":
        samples = np.square(samples)  # rates
    j_pred = jcost.predict(jnp.asarray(samples))
    t_pred = tcost.predict(torch.as_tensor(samples))
    if name == "multimodal":  # left unimplemented, as in the reference
        assert j_pred is None and t_pred is None
        return
    y = np.array(jcost.y_train)
    np.testing.assert_allclose(to_np(t_pred.mean), np.asarray(j_pred.mean), rtol=RTOL)
    np.testing.assert_allclose(to_np(t_pred.log_prob(torch.as_tensor(y))),
                               np.asarray(j_pred.log_prob(jnp.asarray(y))), rtol=RTOL)
    np.testing.assert_allclose(float(t_pred.negative_log_likelihood(torch.as_tensor(y))),
                               float(j_pred.negative_log_likelihood(jnp.asarray(y))), rtol=RTOL)
    if name == "student_t":
        np.testing.assert_allclose(to_np(t_pred.variance), np.asarray(j_pred.variance), rtol=RTOL)


def test_smoothed_with_zero_std_is_the_sigmoid_bernoulli():
    labels = np.asarray(jax_cost("bernoulli", _x()).y_train)
    f = torch.as_tensor(_predictions("smoothed"))
    smoothed = tcosts.make_smoothed_bernoulli_cost(
        torch.as_tensor(labels), torch.zeros(N, dtype=torch.float64))
    plain = tcosts.BernoulliCost(y_train=torch.as_tensor(labels))
    np.testing.assert_allclose(to_np(smoothed.calculate_cost(f)), to_np(plain.calculate_cost(f)),
                               rtol=1e-12)
    np.testing.assert_allclose(to_np(smoothed.calculate_cost_derivative(f)),
                               to_np(plain.calculate_cost_derivative(f)), rtol=1e-12, atol=1e-15)


def test_residual_smoothing_std_matches_jax():
    jbasis, _, x, _ = jax_onb(scaling="nystrom", relative_eigenvalue_threshold=1e-8)
    tbasis, _ = carried(jbasis, jax_cost("gaussian", x))
    k_diag = np.ones(x.shape[0])  # outputscale 1
    expected = jcosts.residual_smoothing_std(jbasis, jnp.asarray(k_diag))
    got = tcosts.residual_smoothing_std(tbasis, torch.as_tensor(k_diag))
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=1e-10, atol=1e-12)
    reference_basis, _ = carried(jax_onb()[0], jax_cost("gaussian", x))
    with pytest.raises(ValueError, match="nystrom"):
        tcosts.residual_smoothing_std(reference_basis, torch.as_tensor(k_diag))


@pytest.mark.parametrize("df", [3.0, 30.0, 1e8])
def test_student_t_log_normalizer_matches_jax(df):
    assert tdist.student_t_log_normalizer(df) == jdist.student_t_log_normalizer(df)
    if df > 1e6:  # the asymptote: the Gaussian limit
        assert abs(tdist.student_t_log_normalizer(df) + 0.5 * np.log(2 * np.pi)) < 1e-8


def test_factory_promotes_int_labels():
    labels = (np.sin(2 * _x()[:, 0]) > 0).astype(np.int64)
    std = np.full(N, 0.5)
    cost = tcosts.make_smoothed_bernoulli_cost(torch.as_tensor(labels), torch.as_tensor(std))
    dtype = torch.get_default_dtype()
    assert cost.y_train.dtype == cost.gh_weights.dtype == dtype and cost.gh_rule == "hermgauss"
    nodes, weights = np.polynomial.hermite.hermgauss(16)
    np.testing.assert_allclose(to_np(cost.gh_weights), weights, rtol=1e-6)  # not truncated
    np.testing.assert_allclose(to_np(cost.gh_nodes), nodes, rtol=1e-6)
    jcost = jcosts.make_smoothed_bernoulli_cost(jnp.asarray(labels), jnp.asarray(std))
    f = _predictions("smoothed")
    np.testing.assert_allclose(  # the default dtype (fp32) against JAX's fp64
        to_np(cost.calculate_cost(torch.as_tensor(f, dtype=dtype))),
        np.asarray(jcost.calculate_cost(jnp.asarray(f))), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="sigmoid"):
        tcosts.make_smoothed_bernoulli_cost(
            labels, std, link_function=convert.link_from_name("probit"))


def test_converters_name_links_by_string():
    y = np.array([0.0, 1.0, 1.0])
    cost = convert.bernoulli_cost_from_numpy({"y_train": y, "link": "probit", "jitter": 1e-6},
                                             device="cpu")
    assert type(cost.link_function).__name__ == "ProbitLinkFunction"
    assert cost.link_function.jitter == 1e-6
    with pytest.raises(ValueError, match="Unknown link"):
        convert.link_from_name("tanh")
