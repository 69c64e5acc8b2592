"""Training on the inducing-point basis: the off tier, the IPB spectral
system and tier, the W-space ONB view and ``train_pls``'s reroute through
it, against the JAX package (CPU, fp64) on the JAX basis carried across with
``convert`` and the normals z the JAX scan draws from its per-step keys (the
IPB's update noise is S z).

The spectral system is compared on quantities that do not depend on
eigenvector signs (sigma, q_out diag(b_rot), q_out diag(sigma) q_in^T = A).
rtol 1e-9 leaves room for the fp64 reassociation of 120 steps and for the
eigh of two drift matrices that differ in the last bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_tpu.training import (
    _train_pls_scan,
    ipb_w_space_view as j_ipb_w_space_view,
    spectral_system_host as j_spectral_system_host,
)
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import J, STEPS, ipb_model, to_np, update_noise

STEP_SIZE, RTOL = 1e-3, 1e-9


def _assert_same_run(got, expected, exit_map=None, rtol=RTOL):
    particles = got.particles if exit_map is None else exit_map(got.particles)
    np.testing.assert_allclose(to_np(particles), np.asarray(expected.particles), rtol=rtol,
                               atol=1e-12)
    np.testing.assert_allclose(to_np(got.energies), np.asarray(expected.energies), rtol=rtol)
    np.testing.assert_array_equal(to_np(got.recorded), np.asarray(expected.recorded))
    assert int(got.steps_run) == int(expected.steps_run)


@pytest.mark.parametrize("name, patience", [
    ("gaussian", np.inf), ("gaussian", 0.01), ("bernoulli", np.inf), ("smoothed", np.inf),
])
def test_off_tier_matches_jax_scan(name, patience):
    jbasis, jcost, tbasis, tcost, u0 = ipb_model(name, mean_constant=0.2)
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE, patience,
                               STEPS, "off")
    got = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, patience, STEPS,
                                 "off", noise=torch.as_tensor(update_noise(jbasis)))
    _assert_same_run(got, expected)
    if patience < 1:
        assert int(got.steps_run) < STEPS


def _sign_free(system):
    sigma, q_in, q_out, b_rot, e_const = (to_np(v) for v in system)
    return {"sigma": sigma, "q_out_b": q_out * b_rot, "q_in_b": q_in * b_rot,
            "drift": (q_out * sigma) @ q_in.T, "e_const": e_const}


def test_spectral_system_matches_jax():
    jbasis, jcost, tbasis, tcost, _ = ipb_model("gaussian", mean_constant=0.2)
    expected = _sign_free(j_spectral_system_host(jbasis, jcost))
    for system in (ttrain.spectral_system_host(tbasis, tcost),
                   ttrain._spectral_system(tbasis, tcost)):
        got = _sign_free(system)
        for name, value in expected.items():
            np.testing.assert_allclose(got[name], value, rtol=RTOL,
                                       atol=RTOL * np.abs(value).max(), err_msg=name)
    # the drift it diagonalises is the quadratic system's A
    a = to_np(ttrain._quadratic_system(tbasis, tcost)[0])
    np.testing.assert_allclose(expected["drift"], a, rtol=RTOL, atol=RTOL * np.abs(a).max())
    with pytest.raises(ValueError, match="W-space ONB view"):
        ttrain.spectral_system_host(tbasis, tcost, "preconditioned")


@pytest.mark.parametrize("patience", [np.inf, 0.01])
def test_spectral_tier_matches_jax(patience):
    jbasis, jcost, tbasis, tcost, u0 = ipb_model("gaussian")
    spec = j_spectral_system_host(jbasis, jcost)
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE, patience,
                               STEPS, "spectral", spec)
    eps_v = jax.vmap(lambda k: jax.random.normal(k, u0.shape, dtype=jnp.float64))(
        jax.random.split(as_key(123), STEPS))
    # JAX's eigenbasis draws as the z of S z: V noise = q^T z, q = S^T q_in
    q_jax = np.asarray(jbasis.noise_factor).T @ np.asarray(spec.q_in)
    got = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, patience, STEPS,
                                 "spectral", ttrain.spectral_system_host(tbasis, tcost),
                                 noise=torch.as_tensor(q_jax[None] @ np.asarray(eps_v)))
    _assert_same_run(got, expected)
    assert ttrain.resolve_fast_path(tbasis, tcost, "auto") == "spectral"


def test_w_space_view_matches_jax_and_the_euler_chain():
    jbasis, jcost, tbasis, tcost, u0 = ipb_model("bernoulli", mean_constant=0.2)
    view, s_mat, s_inv = ttrain.ipb_w_space_view(tbasis)
    j_view, j_s, j_s_inv = j_ipb_w_space_view(jbasis)
    np.testing.assert_allclose(to_np(view.eigenvalues), np.asarray(j_view.eigenvalues),
                               rtol=RTOL)
    p, jp = to_np(view.train_projection), np.asarray(j_view.train_projection)
    np.testing.assert_allclose(p @ p.T, jp @ jp.T, rtol=RTOL, atol=RTOL * np.abs(jp).max() ** 2)
    np.testing.assert_allclose(to_np(s_mat @ s_mat.T), np.asarray(j_s @ j_s.T), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(to_np(s_mat @ s_inv), np.eye(12), atol=1e-12)
    assert view.mean_constant == 0.2
    # the W-space Euler chain with the same normals z is U_t = S W_t
    noise = torch.as_tensor(update_noise(jbasis))
    on_view = ttrain._train_pls_loop(view, tcost, s_inv @ torch.as_tensor(u0), STEP_SIZE,
                                     np.inf, STEPS, "off", noise=noise)
    on_basis = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, np.inf,
                                      STEPS, "off", noise=noise)
    np.testing.assert_allclose(to_np(s_mat @ on_view.particles), to_np(on_basis.particles),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(to_np(on_view.energies), to_np(on_basis.energies), rtol=RTOL)


@pytest.mark.parametrize("fast_path, discretisation", [
    ("general_fused", "euler"), ("general_fused", "exponential"), ("off", "preconditioned"),
])
def test_train_pls_reroute_matches_jax(fast_path, discretisation):
    """The port's W-space run (B3's plain version on general_fused) against
    JAX's W-space off scan; then train_pls takes exactly that route."""
    jbasis, jcost, tbasis, tcost, u0 = ipb_model("student_t")
    j_view, j_s, j_s_inv = j_ipb_w_space_view(jbasis)
    expected = _train_pls_scan(j_view, jcost, j_s_inv @ jnp.asarray(u0), as_key(123), STEP_SIZE,
                               np.inf, STEPS, "off", None, discretisation)
    expected = expected._replace(particles=j_s @ expected.particles)
    assert ttrain.needs_w_space_reroute(tbasis, fast_path, discretisation)
    view, s_mat, s_inv = ttrain.ipb_w_space_view(tbasis)
    tier = ttrain.resolve_tier(view, tcost, fast_path, discretisation)
    assert tier == fast_path
    got = ttrain._train_pls_loop(view, tcost, s_inv @ torch.as_tensor(u0), STEP_SIZE, np.inf,
                                 STEPS, tier, noise=torch.as_tensor(update_noise(jbasis)),
                                 discretisation=discretisation)
    _assert_same_run(got, expected, exit_map=lambda w: s_mat @ w)
    # train_pls runs the same route: the same particles for the same generator
    particles, energies = pt.train_pls(pt.PLS(tbasis, tcost), torch.as_tensor(u0), 30,
                                       STEP_SIZE, generator=5, fast_path=fast_path,
                                       discretisation=discretisation)
    direct = ttrain._train_pls_loop(view, tcost, s_inv @ torch.as_tensor(u0), STEP_SIZE, np.inf,
                                    30, tier, generator=5, discretisation=discretisation)
    np.testing.assert_array_equal(to_np(particles), to_np(s_mat @ direct.particles))
    assert energies == direct.energies.tolist()
    assert not ttrain.needs_w_space_reroute(tbasis, "off", "euler")
    assert particles.shape == (12, J)
