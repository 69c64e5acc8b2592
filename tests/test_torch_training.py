"""Training tiers of the PyTorch port against the JAX scan (CPU, fp64), on a
basis and cost carried across with ``convert``.

The off and quadratic tiers get the noise the JAX scan draws from its
per-step keys. The spectral tier gets JAX's W-space draws mapped to U space
as ``q_jax @ eps_W``; the port rotates them into its own eigenbasis, which
makes the result independent of eigenvector signs. rtol 1e-9 leaves room
for the fp64 reassociation of 50-200 steps (and, on the spectral tier, for
the eigh of two slightly different drift matrices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.models.pls import PLS as TPLS
from projected_langevin_sampling_tpu.models.pls import PLS as JPLS
from projected_langevin_sampling_tpu.training import _train_pls_scan, spectral_system_host
from projected_langevin_sampling_tpu.training import train_pls as j_train_pls
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import carried, carried_ipb, ipb_model, jax_ipb, jax_onb, to_np

J, STEPS, STEP_SIZE = 8, 120, 1e-3
RTOL = 1e-9


def _step_keys():
    return jax.random.split(as_key(123), STEPS)


@pytest.mark.parametrize("tier", ["off", "quadratic", "spectral"])
@pytest.mark.parametrize("patience", [float("inf"), 0.01])
def test_tier_matches_jax_scan(tier, patience):
    jbasis, jcost, _, _ = jax_onb()
    tbasis, tcost = carried(jbasis, jcost)
    u0 = jbasis.initialise_particles(J, key=0)
    spec = spectral_system_host(jbasis, jcost) if tier == "spectral" else None
    expected = _train_pls_scan(
        jbasis, jcost, u0, as_key(123), STEP_SIZE, patience, STEPS, tier, spec
    )
    port_spec = None
    if tier == "spectral":
        m_k = jbasis.approximation_dimension
        eps_w = jax.vmap(lambda k: jax.random.normal(k, (m_k, J), dtype=jnp.float64))(
            _step_keys()
        )
        noise = np.asarray(spec.q_out)[None] @ np.asarray(eps_w)  # q_jax @ eps_W
        port_spec = ttrain.spectral_system_host(tbasis, tcost)
    else:  # the draws of the scan's basis.sample_update_noise per step key
        noise = np.stack([np.asarray(jbasis.sample_update_noise(J, k)) for k in _step_keys()])
    got = ttrain._train_pls_loop(
        tbasis, tcost, torch.as_tensor(np.asarray(u0)), STEP_SIZE, patience, STEPS, tier,
        port_spec, noise=torch.as_tensor(noise),
    )
    np.testing.assert_allclose(to_np(got.particles), np.asarray(expected.particles),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(to_np(got.energies), np.asarray(expected.energies), rtol=RTOL)
    np.testing.assert_array_equal(to_np(got.recorded), np.asarray(expected.recorded))
    assert int(got.steps_run) == int(expected.steps_run)
    if patience < 1:
        assert int(got.steps_run) < STEPS  # the stop path was exercised


def test_train_pls_returns_recorded_energies_like_jax():
    jbasis, jcost, _, _ = jax_onb()
    tbasis, tcost = carried(jbasis, jcost)
    u0 = jbasis.initialise_particles(J, key=0)
    j_u, j_e = j_train_pls(JPLS(jbasis, jcost), u0, 40, STEP_SIZE, key=1, fast_path="off")
    t_u, t_e = ttrain.train_pls(TPLS(tbasis, tcost), torch.as_tensor(np.asarray(u0)), 40,
                                STEP_SIZE, generator=1, fast_path="off")
    assert len(t_e) == len(j_e) == 40 and t_u.shape == j_u.shape
    assert all(np.isfinite(t_e))


def test_tier_resolution():
    jbasis, jcost, _, _ = jax_onb()
    tbasis, tcost = carried(jbasis, jcost)
    assert ttrain.resolve_fast_path(tbasis, tcost, "auto") == "spectral"
    assert ttrain.resolve_fast_path(tbasis, tcost, "spectral_fused") == "spectral"
    assert ttrain.resolve_fast_path(tbasis, tcost, "quadratic") == "quadratic"
    # the general kernel and the split discretisations are ported
    assert ttrain.resolve_fast_path(tbasis, tcost, "general_fused") == "general_fused"
    for discretisation in ("exponential", "preconditioned"):
        assert ttrain.resolve_tier(tbasis, tcost, "general_fused", discretisation) == "general_fused"
        assert ttrain.resolve_tier(tbasis, tcost, "off", discretisation) == "off"
    assert ttrain.resolve_tier(tbasis, tcost, "auto", "exponential") == "off"
    assert ttrain.resolve_tier(tbasis, tcost, "auto", "preconditioned") == "spectral"
    # quadratic_fused resolves on the IPB + Gaussian model and refuses a
    # non-Gaussian cost, as the JAX package's rule (training.py:261-264)
    ibasis, icost = carried_ipb(*jax_ipb()[:2])
    assert ttrain.resolve_fast_path(ibasis, icost, "quadratic_fused") == "quadratic_fused"
    assert ttrain.resolve_fast_path(tbasis, tcost, "quadratic_fused") == "quadratic_fused"
    _, _, ibasis_b, bernoulli, _ = ipb_model("bernoulli")
    with pytest.raises(ValueError, match="GaussianCost"):
        ttrain.resolve_fast_path(ibasis_b, bernoulli, "quadratic_fused")
    with pytest.raises(NotImplementedError, match="not ported"):
        ttrain._train_pls_chunked()
