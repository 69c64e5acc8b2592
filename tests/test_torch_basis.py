"""Linear algebra, the ONB basis, prediction, costs and selection of the
PyTorch port against the JAX package (CPU, fp64).

Eigenvectors may differ in sign between builds, so the basis is compared on
sign-invariant quantities (eigenvalues, Vt diag(lambda) Vt^T, B B^T and
k(Z,X)^T Vt U for a fixed U); rtol 1e-10 leaves room for the fp64
eigenvector perturbation of the eigh. Prediction runs on a basis carried
across with ``convert`` and injected noise: rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.models import link_functions as tlinks
from projected_langevin_sampling_torch.models.basis.orthonormal import (
    build_orthonormal_basis as t_build,
)
from projected_langevin_sampling_torch.models.distributions import MultivariateNormal
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (
    ConditionalVarianceInducingPointSelector as TSelector,
)
from projected_langevin_sampling_torch.models.pls import PLS as TPLS
from projected_langevin_sampling_torch.ops import linalg as tlin
from projected_langevin_sampling_torch.ops.kernels import ARDKernel as TARD
from projected_langevin_sampling_tpu.models import link_functions as jlinks
from projected_langevin_sampling_tpu.models.inducing_point_selectors import (
    ConditionalVarianceInducingPointSelector as JSelector,
)
from projected_langevin_sampling_tpu.ops import linalg as jlin
from projected_langevin_sampling_tpu.ops.kernels import ARDKernel as JARD
from tests.torch_parity import CPU, basis_params, carried, jax_onb, to_np

RTOL = 1e-10


def _sign_invariants(vt, lam, b, k_zx, u):
    vt, lam, b, k_zx = (to_np(a) for a in (vt, lam, b, k_zx))
    return {
        "eigenvalues": lam,
        "vt_lam_vt": (vt * lam) @ vt.T,
        "b_bt": b @ b.T,
        "kzx_vt_u": k_zx.T @ vt @ u[: vt.shape[1]],
    }


@pytest.mark.parametrize(
    "scaling, thresholds",
    [
        ("reference", {"eigenvalue_threshold": 1e-3}),
        ("reference", {"eigenvalue_threshold": 0.0, "relative_eigenvalue_threshold": 1e-6}),
        ("nystrom", {"eigenvalue_threshold": 1e-3}),
        ("nystrom", {"eigenvalue_threshold": 0.0, "relative_eigenvalue_threshold": 1e-6}),
    ],
)
def test_build_matches_jax(scaling, thresholds):
    jbasis, _, x, _ = jax_onb(scaling=scaling, **thresholds)
    params = basis_params(jbasis)
    from projected_langevin_sampling_torch.convert import pls_kernel_from_numpy

    tbasis = t_build(
        pls_kernel_from_numpy(params["kernel"], device=CPU), params["x_induce"], x,
        verbose=False, scaling=scaling, **thresholds,
    )
    assert tbasis.approximation_dimension == jbasis.approximation_dimension
    u = np.random.default_rng(1).normal(size=(16, 5))
    got = _sign_invariants(tbasis.scaled_eigenvectors, tbasis.eigenvalues,
                           tbasis.train_projection, tbasis.base_gram_induce_train, u)
    expected = _sign_invariants(jbasis.scaled_eigenvectors, jbasis.eigenvalues,
                                jbasis.train_projection, jbasis.base_gram_induce_train, u)
    for name in expected:
        # normwise: the nystrom columns carry 1/lambda, which amplifies the
        # ulp-level gram differences in entries that cancel towards 0
        atol = RTOL * np.abs(expected[name]).max()
        np.testing.assert_allclose(got[name], expected[name], rtol=RTOL, atol=atol, err_msg=name)


def test_nystrom_zero_eigenvalue_guard_raises():
    jbasis, _, x, _ = jax_onb()
    params = basis_params(jbasis)
    from projected_langevin_sampling_torch.convert import pls_kernel_from_numpy

    kernel = pls_kernel_from_numpy(params["kernel"], device=CPU)
    z = np.linspace(-2, 2, 40)[:, None]  # dense Z: k(Z,Z) is numerically singular
    with pytest.raises(ValueError, match="numerically-zero"):
        t_build(kernel, z, x, verbose=False, scaling="nystrom")


def test_psd_sqrt_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(8, 8))
    cov = a @ a.T - 0.5 * np.eye(8)  # indefinite: the negative part is clipped
    s_t = to_np(tlin.psd_sqrt(torch.as_tensor(cov)))
    s_j = np.asarray(jlin.psd_sqrt(jnp.asarray(cov)))
    np.testing.assert_allclose(s_t @ s_t.T, s_j @ s_j.T, rtol=RTOL, atol=1e-12)
    s_h = to_np(tlin.psd_sqrt_host(torch.as_tensor(cov)))
    np.testing.assert_allclose(s_h @ s_h.T, s_j @ s_j.T, rtol=RTOL, atol=1e-12)


def test_samplers_with_injected_normals_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 6))
    cov, mean = a @ a.T, rng.normal(size=6)
    factor = jlin.psd_sqrt(jnp.asarray(cov))  # carried factor: sign-exact
    key = jax.random.key(4)
    z = np.asarray(jax.random.normal(key, (6, 10), dtype=jnp.float64))
    expected = jlin.sample_with_factor(key, factor, 10, mean=jnp.asarray(mean))
    got = tlin.sample_with_factor(torch.as_tensor(np.asarray(factor)), 10,
                                  mean=torch.as_tensor(mean), normals=torch.as_tensor(z))
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL)
    z2 = np.asarray(jax.random.normal(key, (6, 6), dtype=jnp.float64))
    expected = jlin.sample_multivariate_normal(key, jnp.asarray(mean), jnp.asarray(cov), (2, 3))
    got = tlin.sample_multivariate_normal(
        torch.as_tensor(mean), torch.as_tensor(cov), (2, 3),
        normals=torch.as_tensor(z2),
        factor=torch.as_tensor(np.asarray(jlin.psd_sqrt(jnp.asarray(cov)))),
    )
    assert got.shape == (2, 3, 6)
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL)


@pytest.mark.parametrize("scaling", ["reference", "nystrom"])
def test_matheron_prediction_matches_jax(scaling):
    extra = {"relative_eigenvalue_threshold": 1e-8} if scaling == "nystrom" else {}
    jbasis, jcost, _, _ = jax_onb(scaling=scaling, **extra)
    tbasis, _ = carried(jbasis, jcost)
    m_k, j = jbasis.approximation_dimension, 7
    rng = np.random.default_rng(5)
    u = rng.normal(size=(m_k, j))
    x_test = np.linspace(-2.5, 2.5, 9)[:, None]
    noise = rng.normal(size=(m_k + 9, j))
    expected = jbasis.predict_untransformed_samples(
        jnp.asarray(u), jnp.asarray(x_test), noise=jnp.asarray(noise)
    )
    got = tbasis.predict_untransformed_samples(
        torch.as_tensor(u), torch.as_tensor(x_test), noise=torch.as_tensor(noise)
    )
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-12)

    # the joint covariance the predictive noise is drawn from
    xj = jnp.asarray(x_test)
    kxz = jbasis.kernel.base_kernel(xj, jbasis.x_induce)
    off = kxz @ jbasis.scaled_eigenvectors * jbasis.eigenvalues[None, :]
    gram_x = (
        jbasis.kernel.base_kernel(xj, xj)
        if scaling == "nystrom"
        else jbasis.kernel.forward(xj, xj, additional_approximation_samples=xj)
    )
    cov_j = np.block([[np.diag(np.asarray(jbasis.eigenvalues)), np.asarray(off).T],
                      [np.asarray(off), np.asarray(gram_x)]])
    cov_t = to_np(tbasis.predictive_noise_covariance(torch.as_tensor(x_test)))
    np.testing.assert_allclose(cov_t, cov_j, rtol=RTOL, atol=1e-12)


def test_chunked_prediction_blocks_are_the_joint_law_per_block():
    jbasis, jcost, _, _ = jax_onb()
    tbasis, tcost = carried(jbasis, jcost)
    pls = TPLS(tbasis, tcost)
    x_test = torch.linspace(-2.5, 2.5, 10, dtype=torch.float64)[:, None]
    u = torch.as_tensor(np.random.default_rng(6).normal(size=(tbasis.approximation_dimension, 4)))
    samples = pls.predict_samples(u, x_test, generator=torch.Generator().manual_seed(0),
                                  chunk_size=4)
    assert samples.shape == (10, 4) and torch.isfinite(samples).all()
    # a block's covariance, with the samples augmented by the whole test batch,
    # equals the joint covariance restricted to the block
    joint = tbasis.predictive_noise_covariance(x_test)
    m_k = tbasis.approximation_dimension
    blocks = x_test[:8].reshape(2, 4, 1)
    kernel = tbasis.kernel
    from projected_langevin_sampling_torch.ops.kernels import augment_approximation_samples

    aug = tbasis.replace(kernel=type(kernel)(
        kernel.base_kernel, augment_approximation_samples(kernel.approximation_samples, x_test)))
    batched = aug.predictive_noise_covariance(blocks, augmentation_samples=x_test[:0])
    idx = list(range(m_k)) + [m_k + 4 + i for i in range(4)]
    np.testing.assert_allclose(to_np(batched[1]), to_np(joint[idx][:, idx]), rtol=RTOL, atol=1e-12)


def test_gaussian_cost_and_links_match_jax():
    jbasis, jcost, _, _ = jax_onb()
    _, tcost = carried(jbasis, jcost)
    f = np.random.default_rng(7).normal(size=(64, 5))
    ft = torch.as_tensor(f)
    np.testing.assert_allclose(to_np(tcost.calculate_cost(ft)),
                               np.asarray(jcost.calculate_cost(jnp.asarray(f))), rtol=1e-12)
    dc = np.asarray(jcost.calculate_cost_derivative(jnp.asarray(f)))
    np.testing.assert_allclose(to_np(tcost.calculate_cost_derivative(ft)), dc, rtol=1e-12)
    np.testing.assert_allclose(
        to_np(tcost.calculate_cost_derivative(ft, force_autograd=True)), dc, rtol=1e-12)
    pred_t, pred_j = tcost.predict(ft), jcost.predict(jnp.asarray(f))
    np.testing.assert_allclose(to_np(pred_t.mean), np.asarray(pred_j.mean), rtol=1e-12)
    np.testing.assert_allclose(to_np(pred_t.variance), np.asarray(pred_j.variance), rtol=1e-12)
    y = np.asarray(jcost.y_train)
    np.testing.assert_allclose(
        float(MultivariateNormal(pred_t.mean, pred_t.variance).negative_log_likelihood(
            torch.as_tensor(y))),
        float(pred_j.negative_log_likelihood(jnp.asarray(y))), rtol=1e-12)
    for name in ["IdentityLinkFunction", "SigmoidLinkFunction", "ProbitLinkFunction",
                 "SquareLinkFunction"]:
        for dtype in (np.float32, np.float64):
            v = (np.linspace(-40, 40, 33)).astype(dtype)
            np.testing.assert_allclose(
                to_np(getattr(tlinks, name)()(torch.as_tensor(v))),
                np.asarray(getattr(jlinks, name)()(jnp.asarray(v))),
                # fp32: 1 + erf(y) cancels in the probit tail, where the two
                # erf implementations differ by an ulp of 1.0
                rtol=2e-7 if dtype == np.float32 else 1e-15,
                atol=1.2e-7 if dtype == np.float32 else 0.0, err_msg=f"{name} {dtype}")


def test_conditional_variance_selector_matches_jax():
    x = np.sort(np.random.default_rng(8).uniform(-1, 1, (60, 1)), axis=0)
    jz, jidx = JSelector()(jnp.asarray(x), m=8,
                            kernel=JARD(jnp.asarray([0.2]), jnp.asarray(1.0)),
                            rng=np.random.default_rng(0))
    tz, tidx = TSelector()(torch.as_tensor(x), m=8,
                           kernel=TARD(torch.tensor([0.2], dtype=torch.float64),
                                       torch.tensor(1.0, dtype=torch.float64)),
                           rng=np.random.default_rng(0))
    np.testing.assert_array_equal(to_np(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(to_np(tz), np.asarray(jz))
