"""The whole slice: the README-demo pipeline (100 points, M=10, fp64) run by
the PyTorch port and by the JAX package on the same inputs and noise (CPU).

Each package selects inducing points with the same numpy generator, builds
its own basis, trains on the spectral tier and tempers. The port's noise is
JAX's: the initial particles and the predictive coefficient noise go through
the sign map between the two builds' eigenvectors, and the training noise is
JAX's W-space draws mapped to U space. The tempered mean, variance and scale
agree within rtol 1e-8 (2000 fp64 steps through two eighs)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import projected_langevin_sampling_torch as pt
import projected_langevin_sampling_tpu as pj
from projected_langevin_sampling_torch.training import _train_pls_loop, spectral_system_host
from projected_langevin_sampling_tpu.training import spectral_system_host as j_spectral_host
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import to_np

RTOL = 1e-8
N, J, STEPS, STEP_SIZE, PATIENCE = 100, 100, 2000, 1e-3, 1.0


def test_readme_demo_slice_matches_jax():
    x = np.linspace(-1, 1, N).reshape(-1, 1)
    y = np.sin(2 * np.pi * x[:, 0]) + 0.1 * np.random.default_rng(0).normal(size=N)
    x_cal = np.linspace(-1, 1, 50).reshape(-1, 1)
    y_cal = np.sin(2 * np.pi * x_cal[:, 0]) + 0.1 * np.random.default_rng(7).normal(size=50)
    cpu = torch.device("cpu")
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    one = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731

    # 1. selection and build, each package on its own
    jkernel = pj.ARDKernel(lengthscales=jnp.asarray([0.1]), outputscale=jnp.asarray(1.0))
    tkernel = pt.ARDKernel(lengthscales=one([0.1]), outputscale=one(1.0))
    jz, _ = pj.ConditionalVarianceInducingPointSelector()(
        jnp.asarray(x), m=10, kernel=jkernel, rng=np.random.default_rng(0))
    tz, _ = pt.ConditionalVarianceInducingPointSelector()(
        tx, m=10, kernel=tkernel, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(to_np(tz), np.asarray(jz))
    jbasis = pj.build_orthonormal_basis(
        pj.PLSKernel(jkernel, jnp.asarray(x)), jz, jnp.asarray(x), verbose=False)
    tbasis = pt.build_orthonormal_basis(pt.PLSKernel(tkernel, tx), tz, tx, verbose=False)
    assert tbasis.device == cpu
    jcost = pj.GaussianCost(y_train=jnp.asarray(y), observation_noise=jnp.asarray(0.5))
    tcost = pt.GaussianCost(y_train=ty, observation_noise=one(0.5))
    jpls, tpls = pj.PLS(jbasis, jcost), pt.PLS(tbasis, tcost)
    m_k = jbasis.approximation_dimension
    assert tbasis.approximation_dimension == m_k
    # port coefficients = signs * JAX coefficients
    signs = np.sign(np.sum(np.asarray(jbasis.scaled_eigenvectors)
                           * to_np(tbasis.scaled_eigenvectors), axis=0))[:, None]

    # 2. initial particles
    u0 = np.asarray(jbasis.initialise_particles(J, key=0))

    # 3. the spectral tier, the noise JAX draws in its eigenbasis
    j_u, _ = pj.train_pls(jpls, jnp.asarray(u0), STEPS, STEP_SIZE,
                          early_stopper_patience=PATIENCE, key=1, fast_path="spectral")
    q_jax = np.asarray(j_spectral_host(jbasis, jcost).q_out)
    keys = jax.random.split(as_key(1), STEPS)
    eps_w = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (m_k, J), dtype=jnp.float64))(keys))
    result = _train_pls_loop(
        tbasis, tcost, torch.as_tensor(signs * u0), STEP_SIZE, PATIENCE, STEPS, "spectral",
        spectral_system_host(tbasis, tcost), noise=torch.as_tensor(signs * (q_jax @ eps_w)),
    )
    np.testing.assert_allclose(signs * to_np(result.particles), np.asarray(j_u),
                               rtol=RTOL, atol=1e-10)

    # 4. tempering: JAX's TemperPLS draws with fold_in(key(0), call); the port
    #    gets the same noise injected
    def jax_noise(call, x_pred):
        key_pred, key_obs = jax.random.split(jax.random.fold_in(as_key(None), call))
        pred = np.array(jbasis.sample_predictive_noise(j_u, jnp.asarray(x_pred), key=key_pred))
        pred[:m_k] *= signs
        obs = np.asarray(jcost.sample_observation_noise(J, key=key_obs))
        return {"predictive_noise": torch.as_tensor(pred),
                "observation_noise": torch.as_tensor(obs)}

    jtemper = pj.TemperPLS(x_calibration=jnp.asarray(x_cal), y_calibration=jnp.asarray(y_cal),
                           pls=jpls, particles=j_u)
    j_pred = jtemper(jnp.asarray(x))
    ttemper = pt.TemperPLS(x_calibration=torch.as_tensor(x_cal),
                           y_calibration=torch.as_tensor(y_cal), pls=tpls,
                           particles=result.particles, **jax_noise(1, x_cal))
    t_pred = ttemper(tx, **jax_noise(2, x))
    np.testing.assert_allclose(ttemper.scale, jtemper.scale, rtol=RTOL)
    np.testing.assert_allclose(to_np(t_pred.mean), np.asarray(j_pred.mean), rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(to_np(t_pred.variance), np.asarray(j_pred.variance), rtol=RTOL)
    rmse = float(np.sqrt(np.mean((to_np(t_pred.mean) - np.sin(2 * np.pi * x[:, 0])) ** 2)))
    assert rmse < 0.35
