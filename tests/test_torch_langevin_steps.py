"""``training.langevin_steps`` of the PyTorch port against the JAX package's
(CPU, fp64), with the normals JAX draws from the same keys.

Every tier runs 120 steps; rtol 1e-9 leaves room for the fp64
reassociation (the Euler general body runs B5's plain version, which sums
the data and prior drifts before scaling by eta). The fused tiers, which JAX
runs only as Pallas kernels, are held to the JAX loop tier of the same
chain: quadratic_fused to quadratic, general_fused to off; and
quadratic_fused with zero noise to the JAX kernel in interpret mode (fp32,
the tolerance of ``tests/test_quadratic_fused.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.ops.cuda import fused_update as tfused
from projected_langevin_sampling_torch.ops.cuda import quadratic_train as tquad
from projected_langevin_sampling_tpu.ops.pallas.quadratic_train import quadratic_train_fused
from projected_langevin_sampling_tpu.training import (
    _quadratic_system,
    langevin_steps as j_langevin_steps,
    spectral_system_host,
)
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.test_quadratic_fused import _setup as jax_quadratic_setup
from tests.torch_parity import (
    J,
    STEPS,
    carried,
    carried_ipb,
    ipb_model,
    jax_ipb,
    jax_onb,
    onb_model,
    to_np,
    update_noise,
)

STEP_SIZE, RTOL = 1e-3, 1e-9


def _model(basis_kind, name):
    if name == "gaussian_model":  # the Gaussian cost the model was built with
        jbasis, jcost, _, _ = jax_onb() if basis_kind == "onb" else jax_ipb()
        tbasis, tcost = (carried if basis_kind == "onb" else carried_ipb)(jbasis, jcost)
        return jbasis, jcost, tbasis, tcost, np.asarray(jbasis.initialise_particles(J, key=0))
    return (onb_model if basis_kind == "onb" else ipb_model)(name)


def _steps(jbasis, jcost, tbasis, tcost, u0, port_fast_path, jax_fast_path, discretisation):
    expected = j_langevin_steps(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE, STEPS,
                                jax_fast_path, None, discretisation)
    got = pt.langevin_steps(tbasis, tcost, torch.as_tensor(u0), None, STEP_SIZE, STEPS,
                            fast_path=port_fast_path, discretisation=discretisation,
                            noise=torch.as_tensor(update_noise(jbasis)))
    return got, expected


@pytest.mark.parametrize("basis_kind, name", [
    ("onb", "gaussian_model"), ("onb", "bernoulli"), ("onb", "smoothed"),
    ("ipb", "gaussian_model"), ("ipb", "poisson"), ("ipb", "student_t"), ("ipb", "multimodal"),
])
def test_off_tier_matches_jax(basis_kind, name):
    """The Euler general body: B5's plain version for the four closed forms,
    the basis's own update for the others."""
    jbasis, jcost, tbasis, tcost, u0 = _model(basis_kind, name)
    before = tfused.fused_update.launches
    got, expected = _steps(jbasis, jcost, tbasis, tcost, u0, "off", "off", "euler")
    assert tfused.fused_update.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("basis_kind", ["onb", "ipb"])
@pytest.mark.parametrize("port_fast_path", ["quadratic", "quadratic_fused"])
def test_quadratic_tiers_match_jax_quadratic(basis_kind, port_fast_path):
    jbasis, jcost, tbasis, tcost, u0 = _model(basis_kind, "gaussian_model")
    before = tquad.quadratic_train.launches
    got, expected = _steps(jbasis, jcost, tbasis, tcost, u0, port_fast_path, "quadratic",
                           "euler")
    assert tquad.quadratic_train.launches == before
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("basis_kind", ["onb", "ipb"])
def test_quadratic_fused_zero_noise_matches_jax_kernel(basis_kind):
    jbasis, jcost = jax_quadratic_setup(basis_kind)
    u0 = np.asarray(jbasis.initialise_particles(16, key=0), dtype=np.float32)
    a, b, e_mat, e_bias, e_const, shared = _quadratic_system(jbasis, jcost)
    with pltpu.force_tpu_interpret_mode():
        expected, _ = quadratic_train_fused(
            a, b, e_mat, e_bias, None if shared else jbasis.noise_factor, jnp.asarray(u0),
            seed=0, eta=STEP_SIZE, patience=jnp.inf, energy_const=e_const, num_steps=25,
            shared=bool(shared), zero_noise=True,
        )
    tbasis, tcost = (carried if basis_kind == "onb" else carried_ipb)(jbasis, jcost)
    m = tbasis.approximation_dimension
    got = pt.langevin_steps(tbasis, tcost, torch.as_tensor(u0), 0, STEP_SIZE, 25,
                            fast_path="quadratic_fused", noise=torch.zeros((25, m, 16)))
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("discretisation", ["exponential", "preconditioned"])
@pytest.mark.parametrize("port_fast_path", ["off", "general_fused"])
def test_split_schemes_match_jax(discretisation, port_fast_path):
    jbasis, jcost, tbasis, tcost, u0 = onb_model("bernoulli")
    got, expected = _steps(jbasis, jcost, tbasis, tcost, u0, port_fast_path, "off",
                           discretisation)
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-12)


def test_general_fused_euler_matches_jax_off():
    jbasis, jcost, tbasis, tcost, u0 = onb_model("student_t")
    got, expected = _steps(jbasis, jcost, tbasis, tcost, u0, "general_fused", "off", "euler")
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-12)


def test_spectral_tier_matches_jax():
    """JAX's eigenbasis draws mapped to U space through its q; the port
    rotates them into its own eigenbasis."""
    jbasis, jcost, tbasis, tcost, u0 = _model("onb", "gaussian_model")
    spec = spectral_system_host(jbasis, jcost)
    expected = j_langevin_steps(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE, STEPS,
                                "spectral", spec)
    eps_w = jax.vmap(lambda k: jax.random.normal(k, u0.shape, dtype=jnp.float64))(
        jax.random.split(as_key(123), STEPS))
    got = pt.langevin_steps(tbasis, tcost, torch.as_tensor(u0), None, STEP_SIZE, STEPS,
                            fast_path="spectral",
                            spectral_system=ttrain.spectral_system_host(tbasis, tcost),
                            noise=torch.as_tensor(np.asarray(spec.q_out)[None] @ np.asarray(eps_w)))
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-12)


def test_ipb_split_scheme_raises_like_jax():
    jbasis, jcost, tbasis, tcost, u0 = _model("ipb", "gaussian_model")
    with pytest.raises(ValueError, match="ipb_w_space_view"):
        j_langevin_steps(jbasis, jcost, jnp.asarray(u0), as_key(1), STEP_SIZE, 3, "auto", None,
                         "preconditioned")
    with pytest.raises(ValueError, match="ipb_w_space_view"):
        pt.langevin_steps(tbasis, tcost, torch.as_tensor(u0), 1, STEP_SIZE, 3,
                          discretisation="preconditioned")
    # and the resolution is JAX's strict=False one
    assert ttrain.resolve_tier(tbasis, tcost, "quadratic", "exponential", strict=False) == "off"
