"""The carrier of the JAX package's PLS draws into the port (CPU, fp64):
``utils/early_stopper.NoiseChunks`` gives a tier the normals of a
(T, M, J) tensor a chunk at a time, and ``tests/torch_parity.jax_run_normals``
rebuilds the normals of a JAX ``train_pls`` run from its key, including the
``fold_in`` keys of a run longer than ``_SCAN_CHUNK_STEPS`` and, for the
spectral tier, the W-space draws rotated into U coordinates. rtol 1e-9 as
the tiers' parity tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_langevin_sampling_tpu as pj
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.utils.early_stopper import NoiseChunks
from projected_langevin_sampling_tpu import training as jtrain
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import J, STEPS, _w_noise_rotation, jax_run_normals, onb_model, to_np

STEP_SIZE, RTOL = 1e-3, 1e-9


@pytest.mark.parametrize("tier, name, discretisation", [
    ("off", "bernoulli", "euler"),
    ("off", "student_t", "preconditioned"),
    ("quadratic", "gaussian", "euler"),
    ("spectral", "gaussian", "preconditioned"),
])
def test_noise_chunks_give_the_tensor_noise(tier, name, discretisation):
    """A run on chunks of 7 steps of the normals is the run on the whole
    (T, M, J) tensor, bit for bit."""
    _, _, tbasis, tcost, u0 = onb_model(name)
    z = torch.randn(STEPS, tbasis.approximation_dimension, J, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    system = (ttrain.spectral_system_host(tbasis, tcost, discretisation)
              if tier == "spectral" else None)
    runs = [ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, np.inf, STEPS,
                                   tier, system, noise=noise, discretisation=discretisation)
            for noise in (z, NoiseChunks(lambda s, n: z[s:s + n], STEPS, chunk_steps=7))]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [None, 50])
@pytest.mark.parametrize("name, discretisation", [
    ("bernoulli", "euler"), ("gaussian", "preconditioned")])
def test_jax_run_normals_replay_a_jax_run(monkeypatch, name, discretisation, chunk):
    """The port's tier on ``jax_run_normals`` of a JAX ``train_pls`` call's
    key gives that call's particles and energies: the off tier, and the
    preconditioned spectral tier (its W-space draws rotated); with
    ``chunk`` the JAX run goes in chunks of 50 steps on ``fold_in`` keys."""
    if chunk is not None:
        monkeypatch.setattr(jtrain, "_SCAN_CHUNK_STEPS", chunk)
    jbasis, jcost, tbasis, tcost, u0 = onb_model(name)
    jpls = pj.PLS(basis=jbasis, cost=jcost)
    expected, energies = jtrain.train_pls(jpls, jnp.asarray(u0), STEPS, STEP_SIZE, key=123,
                                          discretisation=discretisation)
    tier = ttrain.resolve_tier(tbasis, tcost, "auto", discretisation)
    rotation = (_w_noise_rotation(jtrain, jbasis, jcost, discretisation)
                if tier == "spectral" else None)
    assert tier == ("spectral" if name == "gaussian" else "off")
    draw = jax_run_normals(as_key(123), STEPS, (jbasis.approximation_dimension, J), jnp.float64,
                           rotation)
    got = ttrain._train_pls_loop(
        tbasis, tcost, torch.as_tensor(u0), STEP_SIZE, np.inf, STEPS, tier,
        ttrain.spectral_system_host(tbasis, tcost, discretisation) if tier == "spectral" else None,
        noise=NoiseChunks(draw, STEPS, chunk_steps=32), discretisation=discretisation)
    np.testing.assert_allclose(to_np(got.particles), np.asarray(expected), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(to_np(got.energies), energies, rtol=RTOL)
