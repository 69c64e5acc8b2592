"""The slice of the non-Gaussian costs on the orthonormal basis: the general
("off") tier under every discretisation, the preconditioned spectral tier,
tier resolution, and a classification run end to end, against the JAX
package (CPU, fp64), on models carried across with ``convert``.

The port gets the noise the JAX scan draws from its per-step keys (for the
spectral tier, JAX's eigenbasis draws mapped to U space through JAX's
orthogonal factor; the port rotates them into its own eigenbasis). rtol 1e-9
leaves room for the fp64 reassociation of 120 steps; the end-to-end run
(2000 steps, a Newton fit, a predictive draw) gets rtol 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_langevin_sampling_torch as pt
import projected_langevin_sampling_tpu as pj
from projected_langevin_sampling_torch import closed_forms
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_tpu.models import costs as jcosts
from projected_langevin_sampling_tpu.models.link_functions import SigmoidLinkFunction
from projected_langevin_sampling_tpu.models.mean_constant import (
    fit_mean_constant_map as j_fit_mean_constant_map,
)
from projected_langevin_sampling_tpu.training import (
    _train_pls_scan,
    general_fused_cost_spec,
    spectral_system_host,
)
from projected_langevin_sampling_tpu.training import ipb_w_space_view as j_ipb_w_space_view
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import (
    ELIGIBLE,
    J,
    STEPS,
    onb_model,
    update_noise,
    carried,
    carried_cost,
    ipb_model,
    jax_cost,
    jax_onb,
    to_np,
)

STEP_SIZE, RTOL = 1e-3, 1e-9
DISCRETISATIONS = ["euler", "exponential", "preconditioned"]


def _assert_same_run(got, expected, rtol=RTOL):
    np.testing.assert_allclose(to_np(got.particles), np.asarray(expected.particles),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(to_np(got.energies), np.asarray(expected.energies), rtol=rtol)
    np.testing.assert_array_equal(to_np(got.recorded), np.asarray(expected.recorded))
    assert int(got.steps_run) == int(expected.steps_run)


@pytest.mark.parametrize("discretisation", DISCRETISATIONS)
@pytest.mark.parametrize("name", ["bernoulli", "poisson", "student_t", "multimodal", "smoothed"])
def test_off_tier_matches_jax_scan(name, discretisation):
    jbasis, jcost, tbasis, tcost, u0 = onb_model(name)
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE,
                               np.inf, STEPS, "off", None, discretisation)
    got = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, np.inf, STEPS,
                                 "off", noise=torch.as_tensor(update_noise(jbasis)),
                                 discretisation=discretisation)
    _assert_same_run(got, expected)
    assert np.isfinite(to_np(got.energies)).all()


@pytest.mark.parametrize("discretisation, step_size, patience", [
    ("euler", STEP_SIZE, 0.01),
    ("exponential", STEP_SIZE, 0.01),
    # relaxes at rate 1 whatever the spectrum: a longer step reaches the
    # noise floor, where the stopper fires, within the run
    ("preconditioned", 5e-2, 0.3),
])
def test_off_tier_stops_like_jax_scan(discretisation, step_size, patience):
    jbasis, jcost, tbasis, tcost, u0 = onb_model("bernoulli")
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), step_size,
                               patience, STEPS, "off", None, discretisation)
    got = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), step_size, patience, STEPS,
                                 "off", noise=torch.as_tensor(update_noise(jbasis)),
                                 discretisation=discretisation)
    _assert_same_run(got, expected)
    assert int(got.steps_run) < STEPS  # the stop path was exercised


@pytest.mark.parametrize("step_size, patience", [(STEP_SIZE, np.inf), (1e-2, 0.01)])
def test_preconditioned_spectral_tier_matches_jax(step_size, patience):
    jbasis, jcost, tbasis, tcost, u0 = onb_model("gaussian")
    spec = spectral_system_host(jbasis, jcost, "preconditioned")
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), step_size,
                               patience, STEPS, "spectral", spec, "preconditioned")
    m_k = jbasis.approximation_dimension
    eps_w = jax.vmap(lambda k: jax.random.normal(k, (m_k, J), dtype=jnp.float64))(
        jax.random.split(as_key(123), STEPS))
    # JAX's W-space draws in U space through its orthogonal factor Q
    q_jax = np.sqrt(np.asarray(jbasis.eigenvalues))[:, None] * np.asarray(spec.q_in)
    got = ttrain._train_pls_loop(
        tbasis, tcost, torch.as_tensor(u0), step_size, patience, STEPS, "spectral",
        ttrain.spectral_system_host(tbasis, tcost, "preconditioned"),
        noise=torch.as_tensor(q_jax[None] @ np.asarray(eps_w)), discretisation="preconditioned",
    )
    _assert_same_run(got, expected)
    if patience < 1:
        assert int(got.steps_run) < STEPS
    # the in-working-dtype system is the same factorisation
    for a, b in zip(ttrain._spectral_system(tbasis, tcost, "preconditioned"),
                    ttrain.spectral_system_host(tbasis, tcost, "preconditioned")):
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("name", sorted(ELIGIBLE))
def test_general_fused_resolution_matches_jax(name):
    jbasis, jcost, tbasis, tcost, _ = onb_model(name)
    spec = closed_forms.general_fused_cost_spec(tbasis, tcost)
    j_spec = general_fused_cost_spec(jbasis, jcost)
    assert spec[0] == j_spec[0] == ELIGIBLE[name]
    np.testing.assert_allclose(spec[1:4], [float(v) for v in j_spec[1:4]], rtol=1e-15)
    assert (spec[4] is None) == (j_spec[4] is None)
    for discretisation in DISCRETISATIONS:
        assert ttrain.resolve_tier(tbasis, tcost, "general_fused", discretisation) == "general_fused"
    expected_auto = "spectral" if name == "gaussian" else "off"
    assert ttrain.resolve_tier(tbasis, tcost, "auto", "preconditioned") == expected_auto


def test_ineligible_costs_resolve_to_off_and_bad_pairs_raise():
    jbasis, _, x, _ = jax_onb()
    tbasis, _ = carried(jbasis, jax_cost("gaussian", x))
    mixture = jax_cost("multimodal", x).replace(link_function=SigmoidLinkFunction())
    smoothed = jax_cost("smoothed", x)
    custom_rule = smoothed.replace(gh_nodes=1.01 * smoothed.gh_nodes, gh_rule="custom")
    jitter = jax_cost("bernoulli", x).replace(link_function=SigmoidLinkFunction(jitter=1e-6))
    for jcost in (mixture, custom_rule, jitter):
        tcost = carried_cost(jcost)
        assert general_fused_cost_spec(jbasis, jcost) is None
        assert closed_forms.general_fused_cost_spec(tbasis, tcost) is None
        for discretisation in DISCRETISATIONS:
            assert ttrain.resolve_tier(tbasis, tcost, "general_fused", discretisation) == "off"
    gaussian = carried_cost(jax_cost("gaussian", x))
    for fast_path, discretisation in (("quadratic", "exponential"), ("spectral", "exponential"),
                                      ("quadratic", "preconditioned")):
        with pytest.raises(ValueError, match="does not implement"):
            ttrain.resolve_tier(tbasis, gaussian, fast_path, discretisation)
    with pytest.raises(ValueError, match="Unknown discretisation"):
        ttrain.resolve_tier(tbasis, gaussian, "off", "leapfrog")
    with pytest.raises(ValueError, match="not implemented for the 'quadratic' tier"):
        ttrain._train_pls_loop(tbasis, gaussian, torch.zeros((tbasis.approximation_dimension, 2),
                               dtype=torch.float64), STEP_SIZE, np.inf, 2, "quadratic",
                               discretisation="preconditioned")


def test_inducing_point_basis_names_slice_3():
    """A basis type the port does not know raises; the port's IPB trains
    under general_fused and preconditioned through its W-space view, as the
    JAX package does."""

    class UnknownBasis:  # stands for a basis the port has no training path for
        pass

    _, _, _, tcost, u0 = onb_model("bernoulli")
    for fast_path in ("general_fused", "off"):
        with pytest.raises(TypeError, match="UnknownBasis"):
            pt.train_pls(pt.PLS(UnknownBasis(), tcost), torch.as_tensor(u0), 3, STEP_SIZE,
                         fast_path=fast_path, discretisation="preconditioned")

    jbasis, jcost, tbasis, tcost, u0 = ipb_model("bernoulli")
    for fast_path, discretisation in (("general_fused", "euler"),
                                      ("general_fused", "preconditioned"),
                                      ("off", "preconditioned")):
        assert ttrain.needs_w_space_reroute(tbasis, fast_path, discretisation)
        t_u, t_e = pt.train_pls(pt.PLS(tbasis, tcost), torch.as_tensor(u0), 30, STEP_SIZE,
                                generator=7, fast_path=fast_path, discretisation=discretisation)
        assert t_u.shape == u0.shape and len(t_e) == 30 and np.isfinite(t_e).all()
    # the W-space chain with JAX's normals, mapped back by U = S W
    view, s_mat, s_inv = ttrain.ipb_w_space_view(tbasis)
    assert ttrain.resolve_tier(view, tcost, "general_fused", "preconditioned") == "general_fused"
    j_view, j_s, j_s_inv = j_ipb_w_space_view(jbasis)
    expected = _train_pls_scan(j_view, jcost, j_s_inv @ jnp.asarray(u0), as_key(123), STEP_SIZE,
                               np.inf, STEPS, "off", None, "preconditioned")
    got = ttrain._train_pls_loop(view, tcost, s_inv @ torch.as_tensor(u0), STEP_SIZE, np.inf,
                                 STEPS, "off", noise=torch.as_tensor(update_noise(jbasis)),
                                 discretisation="preconditioned")
    np.testing.assert_allclose(to_np(s_mat @ got.particles), np.asarray(j_s @ expected.particles),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(to_np(got.energies), np.asarray(expected.energies), rtol=RTOL)


def test_train_pls_general_fused_on_cpu_runs_the_plain_version():
    from projected_langevin_sampling_torch.ops.cuda import general_train as tgen

    _, _, tbasis, tcost, u0 = onb_model("smoothed")
    before = tgen.general_train.launches
    particles, energies = pt.train_pls(pt.PLS(tbasis, tcost), torch.as_tensor(u0), 30,
                                       STEP_SIZE, generator=0, fast_path="general_fused",
                                       discretisation="exponential")
    assert tgen.general_train.launches == before  # CPU tensors: no kernel launch
    assert particles.shape == u0.shape and len(energies) == 30
    assert np.isfinite(energies).all()


def test_classification_slice_matches_jax():
    """MAP mean, preconditioned training on the off tier, a predictive draw
    and Bernoulli probabilities on a nystrom basis with the residual-smoothed
    cost, each package on its own objects and the same noise."""
    steps, n_test = 2000, 40
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-2, 2, (80, 1)), axis=0)
    labels = (np.sin(2 * x[:, 0]) + 0.2 * rng.normal(size=80) > 0).astype(np.float64)
    x_test = np.linspace(-2, 2, n_test)[:, None]
    jkernel = pj.PLSKernel(pj.ARDKernel(jnp.asarray([0.5]), jnp.asarray(1.0)), jnp.asarray(x))
    z = np.linspace(-2, 2, 12)[:, None]
    jbasis = pj.build_orthonormal_basis(jkernel, jnp.asarray(z), jnp.asarray(x), verbose=False,
                                        scaling="nystrom", relative_eigenvalue_threshold=1e-6)
    tkernel = pt.PLSKernel(pt.ARDKernel(torch.tensor([0.5], dtype=torch.float64),
                                        torch.tensor(1.0, dtype=torch.float64)),
                           torch.as_tensor(x))
    tbasis = pt.build_orthonormal_basis(tkernel, torch.as_tensor(z), torch.as_tensor(x),
                                        verbose=False, scaling="nystrom",
                                        relative_eigenvalue_threshold=1e-6)
    m_k = jbasis.approximation_dimension
    assert tbasis.approximation_dimension == m_k
    signs = np.sign(np.sum(np.asarray(jbasis.scaled_eigenvectors)
                           * to_np(tbasis.scaled_eigenvectors), axis=0))[:, None]
    ones = np.ones(80)
    jcost = jcosts.make_smoothed_bernoulli_cost(
        jnp.asarray(labels), jcosts.residual_smoothing_std(jbasis, jnp.asarray(ones)))
    tcost = pt.make_smoothed_bernoulli_cost(
        torch.as_tensor(labels), pt.residual_smoothing_std(tbasis, torch.as_tensor(ones)))
    np.testing.assert_allclose(to_np(tcost.smoothing_std), np.asarray(jcost.smoothing_std),
                               rtol=1e-8, atol=1e-10)

    # 1. the MAP mean constant
    j_m0 = j_fit_mean_constant_map(jbasis, jcost)
    t_m0 = pt.fit_mean_constant_map(tbasis, tcost)
    np.testing.assert_allclose(t_m0, j_m0, rtol=1e-8)
    jbasis, tbasis = jbasis.replace(mean_constant=j_m0), tbasis.replace(mean_constant=t_m0)

    # 2. preconditioned training on the off tier with JAX's per-step noise
    u0 = np.asarray(jbasis.initialise_particles(J, key=0))
    j_u, j_e = pj.train_pls(pj.PLS(jbasis, jcost), jnp.asarray(u0), steps, 1e-2, key=1,
                            fast_path="off", discretisation="preconditioned")
    keys = jax.random.split(as_key(1), steps)
    noise = np.stack([np.asarray(jbasis.sample_update_noise(J, k)) for k in keys])
    result = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(signs * u0), 1e-2, np.inf,
                                    steps, "off", noise=torch.as_tensor(signs * noise),
                                    discretisation="preconditioned")
    np.testing.assert_allclose(signs * to_np(result.particles), np.asarray(j_u),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(to_np(result.energies), j_e, rtol=1e-8)

    # 3. predict with JAX's predictive noise, then Bernoulli probabilities
    pred_noise = np.array(jbasis.sample_predictive_noise(j_u, jnp.asarray(x_test), key=2))
    j_probs = pj.PLS(jbasis, jcost).predict(jnp.asarray(x_test), j_u,
                                            predictive_noise=jnp.asarray(pred_noise)).probs
    pred_noise[:m_k] *= signs
    t_probs = pt.PLS(tbasis, tcost).predict(torch.as_tensor(x_test), result.particles,
                                            predictive_noise=torch.as_tensor(pred_noise)).probs
    np.testing.assert_allclose(to_np(t_probs), np.asarray(j_probs), rtol=1e-8)
    accuracy = np.mean((to_np(t_probs) > 0.5) == (np.sin(2 * x_test[:, 0]) > 0))
    assert accuracy > 0.8
