"""B4's plain version (``ops/cuda/quadratic_train.py``) and the quadratic
tiers of the port against the JAX package (CPU).

1. With zero noise, against JAX's fused kernel in interpret mode at its test
   size (N=48, M=12, J=16, 25 steps, fp32) for the shared (ONB) and the
   non-shared (IPB) system: rtol 2e-4 / atol 1e-5, the tolerance of
   ``tests/test_quadratic_fused.py`` (both fp32, sums in another order).
2. With injected normals z (the z of the IPB's S z), against the JAX
   quadratic tier in fp64: rtol 1e-9 (reassociation over 120 steps).
3. A diverging step: the same NaN tail and steps_run as JAX's replay of its
   kernel's trace, exactly.
4. On CPU tensors ``train_pls(fast_path="quadratic_fused")`` runs the plain
   version and the launch counter does not move."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.ops.cuda import quadratic_train as tquad
from projected_langevin_sampling_tpu.ops.pallas.quadratic_train import quadratic_train_fused
from projected_langevin_sampling_tpu.training import (
    _quadratic_system,
    _replay_early_stopper,
    _train_pls_scan,
)
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.test_quadratic_fused import _setup as jax_quadratic_setup
from tests.torch_parity import (
    J,
    STEPS,
    carried,
    carried_ipb,
    jax_ipb,
    jax_onb,
    to_np,
    update_noise,
)

STEP_SIZE = 1e-3
T, J_SMALL = 25, 16  # tests/test_quadratic_fused.py's size


def _port_system(tbasis, tcost):
    a, b, e_mat, e_bias, e_const, shared = ttrain._quadratic_system(tbasis, tcost)
    return dict(a=a, b=b, energy_matrix=e_mat, energy_bias=e_bias,
                noise_factor=None if shared else tbasis.noise_factor, e_const=e_const,
                shared=shared)


def _carry(which, jbasis, jcost):
    return (carried if which == "onb" else carried_ipb)(jbasis, jcost)


@pytest.mark.parametrize("which", ["onb", "ipb"])
def test_zero_noise_plain_version_matches_jax_kernel(which):
    jbasis, jcost = jax_quadratic_setup(which)
    u0 = np.asarray(jbasis.initialise_particles(J_SMALL, key=0), dtype=np.float32)
    a, b, e_mat, e_bias, e_const, shared = _quadratic_system(jbasis, jcost)
    with pltpu.force_tpu_interpret_mode():
        u_jax, e_jax = quadratic_train_fused(
            a, b, e_mat, e_bias, None if shared else jbasis.noise_factor, jnp.asarray(u0),
            seed=0, eta=STEP_SIZE, patience=jnp.inf, energy_const=e_const, num_steps=T,
            shared=bool(shared), zero_noise=True,
        )
    tbasis, tcost = _carry(which, jbasis, jcost)
    system = _port_system(tbasis, tcost)
    assert system["shared"] == bool(shared) == (which == "onb")
    u, energies, recorded, steps_run = tquad.quadratic_train(
        **{k: system[k] for k in ("a", "b", "energy_matrix", "energy_bias", "noise_factor")},
        u0=torch.as_tensor(u0), eta=STEP_SIZE, patience=np.inf, e_const=system["e_const"],
        num_steps=T, shared=system["shared"], zero_noise=True,
    )
    assert u.dtype == torch.float32
    np.testing.assert_allclose(to_np(u), np.asarray(u_jax), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(energies), np.asarray(e_jax), rtol=2e-4)
    assert bool(recorded.all()) and int(steps_run) == T


@pytest.mark.parametrize("which", ["onb", "ipb"])
@pytest.mark.parametrize("patience", [np.inf, 0.01])
def test_plain_version_with_injected_normals_matches_jax_quadratic_tier(which, patience):
    jbasis, jcost, _, _ = jax_onb() if which == "onb" else jax_ipb()
    tbasis, tcost = _carry(which, jbasis, jcost)
    u0 = np.asarray(jbasis.initialise_particles(J, key=0))
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE, patience,
                               STEPS, "quadratic")
    noise = torch.as_tensor(update_noise(jbasis))
    before = tquad.quadratic_train.launches
    for tier in ("quadratic", "quadratic_fused"):  # the loop tier and B4's plain version
        got = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, patience,
                                     STEPS, tier, noise=noise)
        np.testing.assert_allclose(to_np(got.particles), np.asarray(expected.particles),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(to_np(got.energies), np.asarray(expected.energies), rtol=1e-9)
        np.testing.assert_array_equal(to_np(got.recorded), np.asarray(expected.recorded))
        assert int(got.steps_run) == int(expected.steps_run)
    assert tquad.quadratic_train.launches == before  # CPU tensors: the plain loop
    if patience < 1:
        assert int(expected.steps_run) < STEPS  # the stop path was exercised


def test_divergence_stops_like_jax_kernel():
    jbasis, jcost = jax_quadratic_setup("ipb")
    u0 = np.asarray(jbasis.initialise_particles(J_SMALL, key=0), dtype=np.float32)
    a, b, e_mat, e_bias, e_const, _ = _quadratic_system(jbasis, jcost)
    eta = 1e4  # diverges: the energy overflows to a non-finite value
    with pltpu.force_tpu_interpret_mode():
        _, e_jax = quadratic_train_fused(
            a, b, e_mat, e_bias, jbasis.noise_factor, jnp.asarray(u0), seed=0, eta=eta,
            patience=jnp.inf, energy_const=e_const, num_steps=T, shared=False, zero_noise=True,
        )
    rec_jax, steps_jax = _replay_early_stopper(e_jax, eta, jnp.inf)
    system = _port_system(*carried_ipb(jbasis, jcost))
    kw = dict(eta=eta, patience=np.inf, e_const=system["e_const"], shared=False, zero_noise=True)
    args = [system[k] for k in ("a", "b", "energy_matrix", "energy_bias", "noise_factor")]
    u, energies, recorded, steps_run = tquad.quadratic_train(*args, torch.as_tensor(u0),
                                                             num_steps=T, **kw)
    assert 1 < int(steps_run) == int(steps_jax) < T
    np.testing.assert_array_equal(to_np(recorded), np.asarray(rec_jax))
    np.testing.assert_array_equal(np.isnan(to_np(energies)), np.isnan(np.asarray(e_jax)))
    # frozen at the stop step: a run of exactly steps_run steps ends there
    exact, _, _, _ = tquad.quadratic_train(*args, torch.as_tensor(u0),
                                           num_steps=int(steps_run), **kw)
    np.testing.assert_array_equal(to_np(u), to_np(exact))


def test_train_pls_quadratic_fused_on_cpu_runs_the_plain_version():
    jbasis, jcost, _, _ = jax_ipb()
    tbasis, tcost = carried_ipb(jbasis, jcost)
    u0 = tbasis.initialise_particles(J, generator=0)
    before = tquad.quadratic_train.launches
    particles, energies = pt.train_pls(pt.PLS(tbasis, tcost), u0, 40, STEP_SIZE, generator=0,
                                       fast_path="quadratic_fused")
    assert tquad.quadratic_train.launches == before
    assert particles.shape == u0.shape and len(energies) == 40 and np.isfinite(energies).all()
    assert energies[-1] < energies[0]


def test_wrapper_refuses_what_it_cannot_launch():
    m = torch.zeros((3, 3), device="meta")
    v = torch.zeros(3, device="meta")
    u = torch.zeros((3, 2), device="meta")
    kw = dict(eta=0.1, patience=1.0, e_const=0.0, num_steps=3)
    with pytest.raises(ValueError, match="particles on meta"):
        tquad.quadratic_train(m, v, m, v, None, u, shared=True, **kw)
    assert tquad.step_operations(512, 1000, shared=False) > 3 * 2 * 512 * 512 * 1000
