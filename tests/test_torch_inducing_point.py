"""The inducing-point basis of the PyTorch port against the JAX package (CPU,
fp64): the build, the training-time quantities with injected normals, the
predictive covariance and Matheron prediction (both solve routes), and a
small IPB slice end to end.

The build is compared factor by factor at rtol 1e-10, normwise (atol 1e-10
x the largest entry) where a factor carries K(Z,Z)^{-1}, whose condition
number (about 130) amplifies ulp-level gram differences; the noise factor S
is an eigenvector product, compared as S S^T. Everything after the build
runs on the JAX basis carried across with ``convert``: rtol 1e-10, and 1e-8
for the slice (2000 steps and a predictive draw)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_langevin_sampling_torch as pt
import projected_langevin_sampling_tpu as pj
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.convert import pls_kernel_from_numpy
from projected_langevin_sampling_torch.ops import linalg as tlin
from projected_langevin_sampling_torch.ops.kernels import augment_approximation_samples
from projected_langevin_sampling_tpu.ops.kernels import (
    augment_approximation_samples as j_augment,
)
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import (
    CPU,
    IPB_FIELDS,
    basis_params_kernel,
    carried_ipb,
    jax_cost,
    jax_ipb,
    to_np,
)

RTOL = 1e-10


def _close(got, expected, rtol=RTOL, err_msg=""):
    expected = np.asarray(expected)
    np.testing.assert_allclose(to_np(got), expected, rtol=rtol,
                               atol=rtol * np.abs(expected).max(), err_msg=err_msg)


@pytest.mark.parametrize("mean_constant", [0.0, 0.4])
def test_build_matches_jax(mean_constant):
    jbasis, _, x, _ = jax_ipb(mean_constant=mean_constant)
    z = np.asarray(jbasis.x_induce)
    tbasis = pt.build_inducing_point_basis(
        pls_kernel_from_numpy(basis_params_kernel(jbasis.kernel), device=CPU), z,
        np.sin(2 * z[:, 0]), x, mean_constant=mean_constant,
    )
    assert tbasis.approximation_dimension == 12 and tbasis.mean_constant == mean_constant
    for name in IPB_FIELDS:
        got, expected = getattr(tbasis, name), getattr(jbasis, name)
        assert tuple(got.shape) == tuple(expected.shape), name
        if name == "noise_factor":
            got, expected = got @ got.T, np.asarray(expected) @ np.asarray(expected).T
        _close(got, expected, err_msg=name)
    assert tbasis.train_projection.is_contiguous()
    # the initial particles recentred on y(Z) - m0
    u_t = tbasis.initialise_particles(5, noise_only=False, generator=0)
    noise = tbasis.initialise_particles(5, generator=0)
    _close(u_t - noise, np.repeat((np.sin(2 * z) - mean_constant), 5, axis=1))


def test_extra_predictive_noise_names_slice_4():
    """Slice 4 brought the extra predictive noise: the IPB takes the
    distribution and adds its draws to the whole (M + N*, J) noise."""
    jbasis, jcost, _, _ = jax_ipb()
    tbasis, _ = carried_ipb(jbasis, jcost)
    extra = np.random.default_rng(9).standard_t(3.0, size=(12 + 4, 5))

    class Fixed:
        def sample(self, generator, shape, dtype=None):
            return torch.as_tensor(extra, dtype=dtype).reshape(shape)

    with_extra = tbasis.replace(additional_predictive_noise_distribution=Fixed())
    x = torch.linspace(-1, 1, 4, dtype=torch.float64)[:, None]
    u = torch.zeros((12, 5), dtype=torch.float64)
    normals = torch.as_tensor(np.random.default_rng(10).normal(size=(16, 5)))
    got = with_extra.sample_predictive_noise(u, x, normals=normals)
    _close(got - tbasis.sample_predictive_noise(u, x, normals=normals), extra)


def test_training_quantities_match_jax():
    jbasis, jcost, _, _ = jax_ipb(mean_constant=0.3)
    tbasis, tcost = carried_ipb(jbasis, jcost)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(12, 6))
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    pred_t = tbasis.calculate_untransformed_train_prediction_samples(ut)
    pred_j = jbasis.calculate_untransformed_train_prediction_samples(uj)
    _close(pred_t, pred_j)
    cost = tcost.calculate_cost(pred_t)
    _close(tbasis.calculate_energy_potential(ut, cost),
           jbasis.calculate_energy_potential(uj, jcost.calculate_cost(pred_j)))
    key = jax.random.key(3)
    z = np.asarray(jax.random.normal(key, (12, 6), dtype=jnp.float64))
    noise_t = tbasis.sample_update_noise(6, normals=torch.as_tensor(z))
    _close(noise_t, jbasis.sample_update_noise(6, key))
    dc = tcost.calculate_cost_derivative(pred_t)
    _close(tbasis.calculate_particle_update(ut, dc, 1e-3, noise=noise_t),
           jbasis.calculate_particle_update(uj, jcost.calculate_cost_derivative(pred_j), 1e-3,
                                            noise=jbasis.sample_update_noise(6, key)))


def _predictive_covariance_jax(jbasis, x):
    xj = jnp.asarray(x)
    gram_x = jbasis.kernel.forward(xj, xj, additional_approximation_samples=xj)
    gram_zx = jbasis.kernel.forward(jbasis.x_induce, xj, additional_approximation_samples=xj)
    return np.block([[np.asarray(jbasis.gram_induce), np.asarray(gram_zx)],
                     [np.asarray(gram_zx).T, np.asarray(gram_x)]])


def test_prediction_matches_jax():
    jbasis, jcost, _, _ = jax_ipb(mean_constant=0.2)
    tbasis, _ = carried_ipb(jbasis, jcost)
    rng = np.random.default_rng(5)
    u = rng.normal(size=(12, 7))
    x_test = np.linspace(-2.5, 2.5, 9)[:, None]
    _close(tbasis.predictive_noise_covariance(torch.as_tensor(x_test)),
           _predictive_covariance_jax(jbasis, x_test))
    # the predictive draw with injected normals (its factor is an eigenvector
    # product, so the draw is held to its covariance, not to JAX's draw)
    normals = np.random.default_rng(8).normal(size=(21, 7))
    noise = tbasis.sample_predictive_noise(torch.as_tensor(u), torch.as_tensor(x_test),
                                           normals=torch.as_tensor(normals))
    factor = tlin.psd_sqrt(torch.as_tensor(_predictive_covariance_jax(jbasis, x_test)))
    _close(noise, to_np(factor @ torch.as_tensor(normals)))
    # then Matheron prediction with JAX's draw through the host-Cholesky solve
    expected_noise = jbasis.sample_predictive_noise(jnp.asarray(u), jnp.asarray(x_test), key=2)
    expected = jbasis.predict_untransformed_samples(jnp.asarray(u), jnp.asarray(x_test),
                                                    noise=expected_noise)
    got = tbasis.predict_untransformed_samples(torch.as_tensor(u), torch.as_tensor(x_test),
                                               noise=torch.as_tensor(np.asarray(expected_noise)))
    _close(got, expected)


def test_batched_prediction_is_the_eigh_route_and_the_joint_per_block():
    jbasis, jcost, _, _ = jax_ipb()
    tbasis, tcost = carried_ipb(jbasis, jcost)
    x_test = np.linspace(-2.5, 2.5, 8)[:, None]
    u = np.random.default_rng(6).normal(size=(12, 4))
    blocks = x_test.reshape(2, 4, 1)
    # a block's covariance, with the samples augmented by the whole test batch,
    # equals the joint covariance restricted to the block
    kernel = tbasis.kernel
    aug = tbasis.replace(kernel=type(kernel)(
        kernel.base_kernel,
        augment_approximation_samples(kernel.approximation_samples, torch.as_tensor(x_test))))
    empty = torch.zeros((0, 1), dtype=torch.float64)
    batched = aug.predictive_noise_covariance(torch.as_tensor(blocks), augmentation_samples=empty)
    joint = tbasis.predictive_noise_covariance(torch.as_tensor(x_test))
    idx = list(range(12)) + [12 + 4 + i for i in range(4)]
    _close(batched[1], to_np(joint)[idx][:, idx])
    # the JAX package's traced route (vmap over blocks: eigh with a floor)
    j_aug = jbasis.replace(kernel=jbasis.kernel.replace(
        approximation_samples=j_augment(jbasis.kernel.approximation_samples,
                                        jnp.asarray(x_test))))
    noise = np.random.default_rng(7).normal(size=(2, 16, 4))
    expected = jax.vmap(lambda xb, nb: j_aug.predict_untransformed_samples(
        jnp.asarray(u), xb, noise=nb, augmentation_samples=jnp.zeros((0, 1))))(
        jnp.asarray(blocks), jnp.asarray(noise))
    got = aug.predict_untransformed_samples(torch.as_tensor(u), torch.as_tensor(blocks),
                                            noise=torch.as_tensor(noise),
                                            augmentation_samples=empty)
    _close(got, expected)
    samples = pt.PLS(tbasis, tcost).predict_samples(torch.as_tensor(u),
                                                    torch.as_tensor(x_test), generator=0,
                                                    chunk_size=4)
    assert samples.shape == (8, 4) and torch.isfinite(samples).all()


def test_ipb_slice_matches_jax():
    """Build, train_pls on the off tier with JAX's normals, then predict with
    JAX's predictive noise: each package on its own objects."""
    steps, n_test = 2000, 30
    jbasis, _, x, _ = jax_ipb()
    jcost = jax_cost("gaussian", x)
    z = np.asarray(jbasis.x_induce)
    tbasis = pt.build_inducing_point_basis(
        pls_kernel_from_numpy(basis_params_kernel(jbasis.kernel), device=CPU), z,
        np.sin(2 * z[:, 0]), x)
    tcost = pt.GaussianCost(torch.as_tensor(np.asarray(jcost.y_train)),
                            torch.as_tensor(np.asarray(jcost.observation_noise)))
    u0 = np.asarray(jbasis.initialise_particles(8, noise_only=False, key=0))
    j_u, j_e = pj.train_pls(pj.PLS(jbasis, jcost), jnp.asarray(u0), steps, 1e-3, key=1,
                            fast_path="off")
    keys = jax.random.split(as_key(1), steps)
    normals = np.stack([np.asarray(jax.random.normal(k, (12, 8), dtype=jnp.float64))
                        for k in keys])
    result = ttrain._train_pls_loop(tbasis, tcost, torch.as_tensor(u0), 1e-3, np.inf, steps,
                                    "off", noise=torch.as_tensor(normals))
    _close(result.particles, j_u, rtol=1e-8)
    np.testing.assert_allclose(to_np(result.energies), j_e, rtol=1e-8)
    x_test = np.linspace(-2, 2, n_test)[:, None]
    pred_noise = jbasis.sample_predictive_noise(j_u, jnp.asarray(x_test), key=2)
    obs_noise = jcost.sample_observation_noise(8, key=3)
    j_pred = pj.PLS(jbasis, jcost).predict(jnp.asarray(x_test), j_u, predictive_noise=pred_noise,
                                           observation_noise=obs_noise)
    t_pred = pt.PLS(tbasis, tcost).predict(
        torch.as_tensor(x_test), result.particles,
        predictive_noise=torch.as_tensor(np.asarray(pred_noise)),
        observation_noise=torch.as_tensor(np.asarray(obs_noise)))
    _close(t_pred.mean, j_pred.mean, rtol=1e-8)
    rmse = np.sqrt(np.mean((to_np(t_pred.mean) - np.sin(2 * x_test[:, 0])) ** 2))
    assert rmse < 0.3
