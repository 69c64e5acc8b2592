"""Grams of the PyTorch port against the JAX package (CPU).

fp64 grams agree to rtol 1e-12 (the same expansion in the same order; only
BLAS summation order differs). The gram kernel's plain version is held in
fp32 against the JAX Pallas gram in interpret mode with that test's
tolerances (rtol 2e-5, atol 1e-6, ``tests/test_pallas.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.ops import kernels as tk
from projected_langevin_sampling_torch.ops.cuda import gram as tgram
from projected_langevin_sampling_tpu.ops import kernels as jk
from projected_langevin_sampling_tpu.ops.pallas import pallas_ard_gram
from tests.torch_parity import to_np

RTOL = 1e-12


def _kernels(d, outputscale=1.7):
    ls = np.linspace(0.5, 2.0, d)
    return (
        jk.ARDKernel(jnp.asarray(ls), jnp.asarray(outputscale)),
        tk.ARDKernel(torch.as_tensor(ls), torch.tensor(outputscale, dtype=torch.float64)),
    )


def _inputs(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("d", [1, 3])
def test_ard_gram_cross_matches_jax(d):
    jkern, tkern = _kernels(d)
    x1, x2 = _inputs((40, d), 0), _inputs((30, d), 1)
    expected = jk.ard_gram(jkern, jnp.asarray(x1), jnp.asarray(x2))
    got = tk.ard_gram(tkern, torch.as_tensor(x1), torch.as_tensor(x2))
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL, atol=1e-300)


def test_ard_gram_same_input_has_exact_diagonal():
    jkern, tkern = _kernels(2)
    x = _inputs((25, 2), 2)
    x[7] = x[3]  # an exact duplicate row
    xj = jnp.asarray(x)
    expected = jk.ard_gram(jkern, xj, xj)  # the JAX same-input contract
    got = tk.ard_gram(tkern, torch.as_tensor(x))  # the port's: x2=None
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL)
    # squared distance exactly 0 on the diagonal: k(x, x) == outputscale
    assert np.all(to_np(torch.diagonal(got)) == 1.7)
    assert to_np(got)[3, 7] <= to_np(got)[3, 3]


def test_ard_gram_diag_and_squared_distance_match_jax():
    jkern, tkern = _kernels(3)
    x1, x2 = _inputs((20, 3), 3), _inputs((20, 3), 4)
    np.testing.assert_allclose(
        to_np(tk.ard_gram(tkern, torch.as_tensor(x1), torch.as_tensor(x2), diag=True)),
        np.asarray(jk.ard_gram(jkern, jnp.asarray(x1), jnp.asarray(x2), diag=True)),
        rtol=RTOL,
    )
    np.testing.assert_allclose(
        to_np(tk.squared_distance(torch.as_tensor(x1), torch.as_tensor(x2))),
        np.asarray(jk.squared_distance(jnp.asarray(x1), jnp.asarray(x2))),
        rtol=RTOL,
        atol=1e-12,  # entries near 0 carry the expansion's absolute cancellation error
    )


def test_pls_gram_and_augmentation_match_jax():
    jkern, tkern = _kernels(1)
    samples, extra = _inputs((30, 1), 5), _inputs((12, 1), 6)
    extra[:4] = samples[:4]  # shared rows are dropped by unique()
    x1, x2 = _inputs((9, 1), 7), _inputs((11, 1), 8)
    aug_j = jk.augment_approximation_samples(jnp.asarray(samples), jnp.asarray(extra))
    aug_t = tk.augment_approximation_samples(torch.as_tensor(samples), torch.as_tensor(extra))
    np.testing.assert_array_equal(to_np(aug_t), np.asarray(aug_j))
    jpls = jk.PLSKernel(jkern, jnp.asarray(samples))
    tpls = tk.PLSKernel(tkern, torch.as_tensor(samples))
    for kwargs_j, kwargs_t in [
        ({}, {}),
        (
            {"additional_approximation_samples": jnp.asarray(extra)},
            {"additional_approximation_samples": torch.as_tensor(extra)},
        ),
    ]:
        expected = jpls.forward(jnp.asarray(x1), jnp.asarray(x2), **kwargs_j)
        got = tpls.forward(torch.as_tensor(x1), torch.as_tensor(x2), **kwargs_t)
        np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=RTOL)
    np.testing.assert_allclose(
        to_np(tk.pls_gram(tkern, torch.as_tensor(x1), torch.as_tensor(x1),
                          torch.as_tensor(samples), diag=True)),
        np.asarray(jk.pls_gram(jkern, jnp.asarray(x1), jnp.asarray(x1),
                               jnp.asarray(samples), diag=True)),
        rtol=RTOL,
    )


@pytest.mark.parametrize("shape", [((100, 3), (70, 3)), ((64, 1), (33, 1))])
def test_gram_plain_version_matches_pallas_gram_fp32(shape):
    (n1, d), (n2, _) = shape
    x1, x2 = _inputs((n1, d), 9, np.float32), _inputs((n2, d), 10, np.float32)
    ls = np.linspace(0.5, 2.0, d).astype(np.float32)
    s1, s2 = x1 / ls, x2 / ls
    before = tgram.ard_gram_scaled.launches
    got = tgram.ard_gram_scaled(torch.as_tensor(s1), torch.as_tensor(s2), 1.7)
    assert tgram.ard_gram_scaled.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32
    pallas = pallas_ard_gram(jnp.asarray(s1), jnp.asarray(s2), outputscale=1.7, tile=32,
                             interpret=True)
    np.testing.assert_allclose(to_np(got), np.asarray(pallas), rtol=2e-5, atol=1e-6)
    jkern = jk.ARDKernel(jnp.asarray(ls), jnp.asarray(1.7, dtype=jnp.float32))
    xla = jk.ard_gram(jkern, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(to_np(got), np.asarray(xla), rtol=2e-5, atol=1e-6)


def test_gram_wrapper_refuses_devices_it_cannot_launch_on():
    x = torch.zeros((4, 1), device="meta")
    with pytest.raises(ValueError):
        tgram.ard_gram_scaled(x, x, 1.0)
