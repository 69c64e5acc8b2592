"""The spectral kernel's plain version and the early stopper against the JAX
package (CPU).

The JAX fused kernel runs in interpret mode, where its PRNG gives zeros, so
the zero-noise recurrence is compared directly (fp32: rtol 1e-5, atol 1e-6
on W as in ``tests/test_pallas.py``; rtol 1e-4 on energies, which sum in
another order). Early stopping is compared on a trace whose energy rises
every step after the first (decay > 1), so the stop step is fixed by
patience / eta whatever the summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from projected_langevin_sampling_torch.ops.cuda import spectral_train as tspec
from projected_langevin_sampling_torch.utils import early_stopper as tstop
from projected_langevin_sampling_tpu.ops.pallas.spectral_train import spectral_train_fused
from projected_langevin_sampling_tpu.training import _replay_early_stopper
from projected_langevin_sampling_tpu.utils.early_stopper import EarlyStopper
from tests.torch_parity import to_np

M, J, T = 16, 32, 40


def _coefficients(rising: bool):
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(M, J)).astype(np.float32)
    sigma = rng.uniform(1, 5, M).astype(np.float32)
    b = rng.normal(size=M).astype(np.float32)
    eta = 0.05
    decay = (1.0 + eta * sigma if rising else 1.0 - eta * sigma).astype(np.float32)
    shift = (eta * b).astype(np.float32)
    if rising:
        w0 = np.abs(w0) + 1.0  # energy 0.5 sigma w^2 - b w grows with |w| here
        b = -np.abs(b)
    return w0, decay, shift, sigma, b, eta


def _run_both(rising: bool, patience: float):
    w0, decay, shift, sigma, b, eta = _coefficients(rising)
    with pltpu.force_tpu_interpret_mode():
        w_jax, e_jax = spectral_train_fused(
            jnp.asarray(w0), jnp.asarray(decay), jnp.asarray(shift), jnp.asarray(sigma),
            jnp.asarray(b), seed=0, eta=eta, patience=patience, energy_const=1.0, num_steps=T,
        )
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    before = tspec.spectral_train.launches
    w, e, recorded, steps_run = tspec.spectral_train(
        t(w0), t(decay), t(shift), t(sigma), t(b), eta=eta, patience=patience, e_const=1.0,
        num_steps=T, noise_scale=float(np.sqrt(2 * eta)), zero_noise=True,
    )
    assert tspec.spectral_train.launches == before  # CPU tensors: the plain loop
    return (np.asarray(w_jax), np.asarray(e_jax), eta), (to_np(w), to_np(e), recorded, steps_run)


def test_zero_noise_plain_version_matches_jax_kernel():
    (w_jax, e_jax, _), (w, e, recorded, steps_run) = _run_both(rising=False, patience=np.inf)
    np.testing.assert_allclose(w, w_jax, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e, e_jax, rtol=1e-4)
    assert bool(recorded.all()) and int(steps_run) == T


def test_rising_energy_stop_matches_jax():
    (w_jax, e_jax, eta), (w, e, recorded, steps_run) = _run_both(rising=True, patience=0.22)
    rec_jax, steps_jax = _replay_early_stopper(jnp.asarray(e_jax), eta, 0.22)
    # energy rises after step 0: the stop is the 5th non-improving step
    assert int(steps_jax) == 6
    assert int(steps_run) == int(steps_jax)
    np.testing.assert_array_equal(to_np(recorded), np.asarray(rec_jax))
    np.testing.assert_array_equal(np.isnan(e), np.isnan(e_jax))
    assert np.isnan(e[6:]).all() and np.isfinite(e[:6]).all()  # the stop step is written
    np.testing.assert_allclose(e[:6], e_jax[:6], rtol=1e-4)
    np.testing.assert_allclose(w, w_jax, rtol=1e-5, atol=1e-6)  # frozen at the stop step


@pytest.mark.parametrize(
    "trace, step_size, patience",
    [
        ([3.0, 2.0, 2.0, 2.0, 2.0, 2.0], 1.0, 2.0),
        ([5.0, 4.0, 4.5, 3.0, 3.5, 3.6, 3.7, 2.0], 0.1, 0.25),
        ([5.0, 4.0, np.nan, 3.0], 0.1, 10.0),
        ([5.0, 4.0, 3.0, 2.0], 0.1, np.inf),
    ],
)
def test_replay_early_stopper_matches_jax(trace, step_size, patience):
    trace = np.asarray(trace)
    rec_jax, steps_jax = _replay_early_stopper(jnp.asarray(trace), step_size, patience)
    rec, steps = tstop.replay_early_stopper(torch.as_tensor(trace), step_size, patience)
    np.testing.assert_array_equal(to_np(rec), np.asarray(rec_jax))
    assert int(steps) == int(steps_jax)
    stopper_j, stopper_t = EarlyStopper(patience), tstop.EarlyStopper(patience)
    for loss in trace:
        assert stopper_t.should_stop(float(loss), step_size) == stopper_j.should_stop(
            float(loss), step_size
        )


def test_spectral_wrapper_refuses_devices_it_cannot_launch_on():
    w = torch.zeros((4, 3), device="meta")
    c = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        tspec.spectral_train(w, c, c, c, c, eta=0.1, patience=1.0, e_const=0.0,
                             num_steps=3, noise_scale=0.1)
