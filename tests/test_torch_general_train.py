"""B3's plain version (``ops/cuda/general_train.py``) against the JAX package
(CPU).

1. With injected noise, against the JAX off-tier scan in fp64 at rtol 1e-9:
   the same recurrence and closed forms, only reassociated (the mixture's
   and the probit's closed forms against JAX's autograd). This pins the plain
   version's math, which the chip smoke test holds the kernel to.
2. With zero noise, against JAX's own fused kernel in interpret mode at its
   test size (N=50, M=12, J=16, 20 steps, fp32): rtol 2e-2, atol 2e-4 on the
   particles and rtol 2e-2 on the energies, the tolerance of
   ``tests/test_general_fused.py``, because the JAX kernel feeds bf16
   operands to its matrix unit (about 4e-3 relative per product) where the
   plain version keeps fp32.
3. A diverging step size: the same stop step, recorded flags and NaN tail as
   JAX's replay of its kernel's trace."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from projected_langevin_sampling_torch import closed_forms
from projected_langevin_sampling_torch.ops.cuda import general_train as tgen
from projected_langevin_sampling_tpu.ops.pallas.general_train import general_train_fused
from projected_langevin_sampling_tpu.training import (
    _replay_early_stopper,
    _train_pls_scan,
    general_fused_cost_spec,
)
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.test_general_fused import _setup as jax_fused_setup
from tests.torch_parity import (
    ELIGIBLE,
    STEPS,
    onb_model,
    update_noise,
    carried,
    to_np,
)

STEP_SIZE = 1e-3


def _spec_args(tbasis, tcost):
    kind, params, aux = closed_forms.general_fused_form(tbasis, tcost)
    return kind, dict(params=params, mean_shift=tbasis.mean_constant, aux=aux)


@pytest.mark.parametrize("name, discretisation", [
    (name, ("euler", "exponential", "preconditioned")[i % 3])
    for i, name in enumerate(sorted(ELIGIBLE))
])
def test_plain_version_with_noise_matches_jax_off_scan(name, discretisation):
    jbasis, jcost, tbasis, tcost, u0 = onb_model(name)
    expected = _train_pls_scan(jbasis, jcost, jnp.asarray(u0), as_key(123), STEP_SIZE, np.inf,
                               STEPS, "off", None, discretisation)
    kind, kwargs = _spec_args(tbasis, tcost)
    before = tgen.general_train.launches
    u, energies, recorded, steps_run = tgen.general_train(
        tbasis.train_projection, torch.as_tensor(u0), tcost.y_train, tbasis.eigenvalues, kind,
        eta=STEP_SIZE, patience=np.inf, num_steps=STEPS, discretisation=discretisation,
        noise=torch.as_tensor(update_noise(jbasis)), **kwargs,
    )
    assert tgen.general_train.launches == before  # CPU tensors: the plain loop
    np.testing.assert_allclose(to_np(u), np.asarray(expected.particles), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(to_np(energies), np.asarray(expected.energies), rtol=1e-9)
    assert bool(recorded.all()) and int(steps_run) == STEPS


J_SMALL, T = 16, 20  # tests/test_general_fused.py's size (N = 50, M = 12)


def _fp32_model(name):
    """JAX's own fp32 test model of cost ``name`` (``tests/test_general_fused.py``,
    whose bf16 replay holds the JAX kernel at this tolerance), and the port's.
    The Poisson square link trains at a mean constant of 2 from small
    particles, so that F stays away from its pole at 0, where fp32 and bf16
    trajectories part."""
    jbasis, jcost, _ = jax_fused_setup(ELIGIBLE[name])
    # P rounded to bf16 on both sides, so that the JAX kernel's bf16 copy of
    # P is exact and only its bf16 casts of U and dc remain
    p_bf16 = jnp.asarray(jbasis.train_projection, jnp.bfloat16).astype(jnp.float32)
    jbasis = jbasis.replace(train_projection=p_bf16)
    u0 = np.array(jbasis.initialise_particles(J_SMALL, key=0), dtype=np.float32)
    if name == "poisson":
        jbasis = jbasis.replace(mean_constant=2.0)
        u0 = 0.2 * u0
    tbasis, tcost = carried(jbasis, jcost)
    return jbasis, jcost, tbasis, tcost, u0


@pytest.mark.parametrize("name, discretisation", [
    *((name, "euler") for name in sorted(ELIGIBLE)),
    ("bernoulli", "exponential"), ("student_t", "exponential"),
    ("smoothed", "preconditioned"), ("poisson", "preconditioned"),
])
def test_zero_noise_plain_version_matches_jax_kernel(name, discretisation):
    jbasis, jcost, tbasis, tcost, u0 = _fp32_model(name)
    kind, p0, p1, p2, aux = general_fused_cost_spec(jbasis, jcost)
    with pltpu.force_tpu_interpret_mode():
        u_jax, e_jax = general_train_fused(
            jbasis.train_projection, jnp.asarray(u0), jcost.y_train, jbasis.eigenvalues, kind,
            seed=0, eta=STEP_SIZE, patience=jnp.inf, num_steps=T, cost_param0=p0,
            cost_param1=p1, cost_param2=p2, mean_shift=jbasis.mean_constant, aux=aux,
            zero_noise=True, discretisation=discretisation,
        )
    t_kind, kwargs = _spec_args(tbasis, tcost)
    assert t_kind == kind
    u, energies, recorded, steps_run = tgen.general_train(
        tbasis.train_projection, torch.as_tensor(u0), tcost.y_train, tbasis.eigenvalues, kind,
        eta=STEP_SIZE, patience=np.inf, num_steps=T, discretisation=discretisation,
        zero_noise=True, **kwargs,
    )
    assert u.dtype == torch.float32
    np.testing.assert_allclose(to_np(u), np.asarray(u_jax), rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(to_np(energies), np.asarray(e_jax), rtol=2e-2)
    assert bool(recorded.all()) and int(steps_run) == T


def test_diverging_step_stops_like_jax_replay():
    jbasis, jcost, tbasis, tcost, u0 = _fp32_model("gaussian")
    eta = 50.0  # diverges: the energy overflows to a non-finite value
    with pltpu.force_tpu_interpret_mode():
        _, e_jax = general_train_fused(
            jbasis.train_projection, jnp.asarray(u0), jcost.y_train, jbasis.eigenvalues,
            "gaussian", seed=0, eta=eta, patience=jnp.inf, num_steps=T,
            cost_param0=float(jcost.observation_noise), zero_noise=True,
        )
    rec_jax, steps_jax = _replay_early_stopper(e_jax, eta, jnp.inf)
    kind, kwargs = _spec_args(tbasis, tcost)
    u, energies, recorded, steps_run = tgen.general_train(
        tbasis.train_projection, torch.as_tensor(u0), tcost.y_train, tbasis.eigenvalues, kind,
        eta=eta, patience=np.inf, num_steps=T, zero_noise=True, **kwargs,
    )
    assert 1 < int(steps_run) == int(steps_jax) < T
    np.testing.assert_array_equal(to_np(recorded), np.asarray(rec_jax))
    np.testing.assert_array_equal(np.isnan(to_np(energies)), np.isnan(np.asarray(e_jax)))
    # frozen at the stop step: a run of exactly steps_run steps ends there
    exact, _, _, _ = tgen.general_train(
        tbasis.train_projection, torch.as_tensor(u0), tcost.y_train, tbasis.eigenvalues, kind,
        eta=eta, patience=np.inf, num_steps=int(steps_run), zero_noise=True, **kwargs,
    )
    np.testing.assert_array_equal(to_np(u), to_np(exact))


def test_wrapper_refuses_what_it_cannot_launch():
    p = torch.zeros((5, 3), device="meta")
    u = torch.zeros((3, 2), device="meta")
    y = torch.zeros(5, device="meta")
    lam = torch.ones(3, device="meta")
    kw = dict(eta=0.1, patience=1.0, num_steps=3)
    with pytest.raises(ValueError, match="particles on meta"):
        tgen.general_train(p, u, y, lam, "gaussian", **kw)
    with pytest.raises(ValueError, match="unknown cost kind"):
        tgen.general_train(p, u, y, lam, "hinge", **kw)
    with pytest.raises(ValueError, match="unknown discretisation"):
        tgen.general_train(p, u, y, lam, "gaussian", discretisation="leapfrog", **kw)
    assert tgen.step_operations("gaussian", 5000, 512, 1000) > 4 * 5000 * 512 * 1000
