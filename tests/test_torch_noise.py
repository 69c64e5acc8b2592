"""Extra predictive noise, the random inducing-point selector and the PRNG
helpers of the port (CPU, fp64).

Parity of the extra noise: both packages predict twice from one seed, with
and without the extra noise, and the difference of the two is compared. The
extra draws are injected by a fixed distribution that hands back the same
array in both packages, and a Gaussian draw does not depend on whether
extra noise follows it, so the difference is the Matheron map of the
injected draws in each package (rtol 1e-10, absolute floor 1e-12 of the
largest value). The port's own Student-T draws are held to their law.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import projected_langevin_sampling_torch as pt
import projected_langevin_sampling_tpu as pj
from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_torch.models.basis.noise_distributions import (
    NormalPredictiveNoise,
    StudentTPredictiveNoise,
    standard_gamma,
    student_t,
)
from projected_langevin_sampling_torch.models.inducing_point_selectors.random import (
    RandomInducingPointSelector as TRandom,
)
from projected_langevin_sampling_torch.utils import prng
from projected_langevin_sampling_tpu.models.inducing_point_selectors.random import (
    RandomInducingPointSelector as JRandom,
)
from tests.torch_parity import carried, carried_ipb, jax_ipb, jax_onb, to_np

RTOL = 1e-10


class _JaxFixed:
    """Injected extra draws for the JAX package: ``e`` broadcast to the
    requested shape (every prediction block gets the same draws)."""

    def __init__(self, e):
        self.e = e

    def sample(self, key, shape, dtype=None):
        return jnp.asarray(np.broadcast_to(self.e, shape), dtype=dtype)


class _TorchFixed(_JaxFixed):
    def sample(self, generator, shape, dtype=None):
        return torch.as_tensor(np.broadcast_to(self.e, shape).copy(), dtype=dtype)


def _models(kind):
    if kind == "onb":
        jbasis, jcost, _, _ = jax_onb()
        tbasis, tcost = carried(jbasis, jcost)
    else:
        jbasis, jcost, _, _ = jax_ipb()
        tbasis, tcost = carried_ipb(jbasis, jcost)
    return jbasis, jcost, tbasis, tcost


@pytest.mark.parametrize("chunk", [None, 4], ids=["joint", "chunked"])
@pytest.mark.parametrize("kind", ["onb", "ipb"])
def test_extra_noise_reaches_both_predict_routes_as_in_jax(kind, chunk):
    jbasis, jcost, tbasis, tcost = _models(kind)
    m, j, n_test = jbasis.approximation_dimension, 5, 10
    rows = m + (n_test if chunk is None else chunk)
    e = np.random.default_rng(4).standard_t(3.0, size=(rows, j))
    u = np.random.default_rng(5).normal(size=(m, j))
    x_test = np.linspace(-2.3, 2.1, n_test)[:, None]

    def jax_pred(dist):
        pls = pj.PLS(jbasis.replace(additional_predictive_noise_distribution=dist), jcost)
        return np.asarray(pls.predict_samples(jnp.asarray(u), jnp.asarray(x_test), key=7,
                                              chunk_size=chunk))

    def torch_pred(dist):
        pls = pt.PLS(tbasis.replace(additional_predictive_noise_distribution=dist), tcost)
        return to_np(pls.predict_samples(torch.as_tensor(u), torch.as_tensor(x_test),
                                         generator=torch.Generator().manual_seed(7),
                                         chunk_size=chunk))

    j_diff = jax_pred(_JaxFixed(e)) - jax_pred(None)
    t_diff = torch_pred(_TorchFixed(e)) - torch_pred(None)
    assert np.abs(t_diff).max() > 0.1  # the extra noise moved the samples
    np.testing.assert_allclose(t_diff, j_diff, rtol=RTOL, atol=1e-12 * np.abs(j_diff).max())


def test_extra_noise_on_the_basis_block_too():
    """The extra draws land on the whole (M + N*, J) noise: on the ONB the
    difference is e_x - k(x, Z) Vt e_Z, the basis block entering through the
    Matheron correction."""
    jbasis, jcost, tbasis, tcost = _models("onb")
    m = jbasis.approximation_dimension
    x_test = torch.linspace(-2, 2, 6, dtype=torch.float64)[:, None]
    e = np.random.default_rng(6).normal(size=(m + 6, 3))
    u = torch.as_tensor(np.random.default_rng(7).normal(size=(m, 3)))
    with_e = tbasis.replace(additional_predictive_noise_distribution=_TorchFixed(e))
    diff = (with_e.predict_untransformed_samples(u, x_test, generator=0)
            - tbasis.predict_untransformed_samples(u, x_test, generator=0))
    kxz = tbasis.kernel.base_kernel(x_test, tbasis.x_induce)
    expected = torch.as_tensor(e[m:]) - kxz @ (tbasis.scaled_eigenvectors @ torch.as_tensor(e[:m]))
    np.testing.assert_allclose(to_np(diff), to_np(expected), rtol=RTOL, atol=1e-12)


def test_builders_take_the_extra_noise():
    _, _, x, _ = jax_onb()
    kernel = convert.pls_kernel_from_numpy(
        {"base_kernel": {"lengthscales": np.array([0.4]), "outputscale": np.array(1.0)},
         "approximation_samples": x}, device="cpu")
    dist = StudentTPredictiveNoise(df=4.0, scale=0.1)
    z = np.linspace(-2, 2, 8)[:, None]
    onb = pt.build_orthonormal_basis(kernel, z, x, eigenvalue_threshold=1e-3, verbose=False,
                                     additional_predictive_noise_distribution=dist)
    ipb = pt.build_inducing_point_basis(kernel, z, np.sin(2 * z[:, 0]), x,
                                        additional_predictive_noise_distribution=dist)
    for basis in (onb, ipb):
        assert basis.additional_predictive_noise_distribution is dist
        u = basis.initialise_particles(4, generator=torch.Generator().manual_seed(0))
        noise = basis.sample_predictive_noise(u, torch.as_tensor(z[:3]), generator=1)
        assert noise.shape == (basis.approximation_dimension + 3, 4)
        assert noise.dtype == torch.float64 and torch.isfinite(noise).all()


@pytest.mark.parametrize("df", [0.7, 4.5, 50.0, 1e6])
def test_student_t_draws_follow_their_law(df):
    """At a fixed seed, the Kolmogorov-Smirnov distance of 40,000 draws to
    the t law is below 1.63 / sqrt(n) = 0.0081, the statistic's 99% point."""
    n = 40_000
    draws = student_t(df, (n,), torch.Generator().manual_seed(11))
    assert draws.dtype == torch.float64 and draws.shape == (n,)
    assert scipy.stats.kstest(to_np(draws), "t", args=(df,)).statistic < 1.63 / np.sqrt(n)


@pytest.mark.parametrize("a", [0.3, 1.0, 5.5])
def test_gamma_draws_have_their_moments(a):
    """Mean a and variance a of Gamma(a, 1), within 5 standard errors of
    the sample mean and sample variance of 40,000 draws."""
    n = 40_000
    g = to_np(standard_gamma(a, (n,), torch.Generator().manual_seed(12)))
    assert np.all(g >= 0)
    assert abs(g.mean() - a) < 5 * np.sqrt(a / n)
    var_se = np.sqrt((6 * a + 2 * a * a) / n)  # the fourth central moment is 6a + 3a^2
    assert abs(g.var() - a) < 5 * var_se


def test_noise_distributions_sample_shapes_and_scales():
    gen = torch.Generator().manual_seed(13)
    t = StudentTPredictiveNoise(df=5.0, loc=1.0, scale=2.0).sample(gen, (200, 100),
                                                                   dtype=torch.float32)
    assert t.shape == (200, 100) and t.dtype == torch.float32
    # median loc; variance scale^2 df/(df - 2) = 6.67, within 15% at 20,000 draws
    # (the sample variance of a t with 5 degrees of freedom spreads widely)
    assert abs(float(t.median()) - 1.0) < 0.05
    assert abs(float(t.var()) / (4.0 * 5.0 / 3.0) - 1.0) < 0.15
    z = NormalPredictiveNoise(loc=-1.0, scale=0.5).sample(gen, (20_000,), dtype=torch.float64)
    assert abs(float(z.mean()) + 1.0) < 0.02 and abs(float(z.std()) - 0.5) < 0.01
    same = StudentTPredictiveNoise(df=3.3).sample(torch.Generator().manual_seed(1), (50,))
    again = StudentTPredictiveNoise(df=3.3).sample(torch.Generator().manual_seed(1), (50,))
    assert torch.equal(same, again)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_random_selector_matches_jax(as_tensor):
    x = np.random.default_rng(0).normal(size=(40, 3))
    j_z, j_idx = JRandom()(jnp.asarray(x), 7, None, rng=np.random.default_rng(3))
    kernel = pt.ARDKernel(torch.ones(3, dtype=torch.float64), torch.tensor(1.0))
    tx = torch.as_tensor(x) if as_tensor else x
    t_z, t_idx = TRandom()(tx, 7, kernel, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(to_np(t_idx), np.asarray(j_idx))
    np.testing.assert_array_equal(to_np(t_z), np.asarray(j_z))
    assert t_z.device.type == "cpu"


def test_prng_helpers():
    gen = prng.set_seed(5, device="cpu")
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    first = np.random.rand()
    prng.set_seed(5, device="cpu")
    assert np.random.rand() == first  # numpy's global generator is seeded
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))
    draws = prng.normal(torch.Generator().manual_seed(1), (4000,), dtype=torch.float64,
                        mean=2.0, stdev=3.0)
    assert draws.dtype == torch.float64 and abs(float(draws.mean()) - 2.0) < 0.25
    x = torch.arange(20, dtype=torch.float64).reshape(10, 2)
    point = prng.sample_point(torch.Generator().manual_seed(4), x)
    assert point.shape == (1, 2) and any(torch.equal(point[0], row) for row in x)
    assert torch.equal(point, prng.sample_point(torch.Generator().manual_seed(4), x))
    picks = {int(prng.sample_point(seed, x)[0, 0]) for seed in range(40)}
    assert len(picks) > 3  # the index comes from the generator
