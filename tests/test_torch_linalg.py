"""The Cholesky family of the PyTorch port (``ops/linalg.py``) against the JAX
package (CPU, fp64) on a healthy, a borderline and an indefinite matrix.

The borderline matrix has one eigenvalue at -3e-8 of a spectrum in [0.5, 2]:
the plain factor fails, 1e-7 of jitter rescues it. The indefinite one has an
eigenvalue at -1: every attempt fails (NaN factors; robust_cholesky raises).
Both packages call LAPACK's potrf on the same fp64 inputs, so the factors
agree to rounding: rtol 1e-12, normwise (atol 1e-12 x the largest entry),
since a factor rescued by jitter ends in a pivot of about 1.6e-3, the square
root of a cancellation, whose relative rounding is some 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.ops import linalg as tlin
from projected_langevin_sampling_tpu.ops import linalg as jlin
from tests.torch_parity import to_np

RTOL = 1e-12


def _matrix(kind: str, m: int = 8, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    w = np.linspace(0.5, 2.0, m)
    if kind == "borderline":
        w[0] = -3e-8
    elif kind == "indefinite":
        w[0] = -1.0
    return (q * w) @ q.T


def _same(got, expected):
    got, expected = to_np(got), np.asarray(expected)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expected))
    finite = np.isfinite(expected)
    scale = np.abs(expected[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=RTOL * scale, equal_nan=True)


@pytest.mark.parametrize("kind", ["healthy", "borderline", "indefinite"])
def test_cholesky_family_matches_jax(kind):
    a = _matrix(kind)
    at, aj = torch.as_tensor(a), jnp.asarray(a)
    for jitter in (0.0, 1e-7):
        _same(tlin.cholesky_factor(at, jitter), jlin.cholesky_factor(aj, jitter))
    _same(tlin.psd_safe_cholesky(at, 1e-9), jlin.psd_safe_cholesky(aj, 1e-9))
    _same(tlin.nan_rescued_cholesky(at, 1e-7), jlin.nan_rescued_cholesky(aj, 1e-7))
    if kind == "healthy":
        rhs = np.random.default_rng(1).normal(size=(8, 3))
        chol = tlin.cholesky_factor(at)
        _same(tlin.cholesky_solve(chol, torch.as_tensor(rhs)),
              jlin.cholesky_solve(jnp.asarray(to_np(chol)), jnp.asarray(rhs)))
        np.testing.assert_allclose(a @ to_np(tlin.cholesky_solve(chol, torch.as_tensor(rhs))),
                                   rhs, rtol=1e-10, atol=1e-12)
    # the batch dimension the port adds: each matrix on its own
    batch = torch.stack([at, torch.as_tensor(_matrix("healthy", seed=2))])
    for fn in (lambda t: tlin.psd_safe_cholesky(t, 1e-9), tlin.nan_rescued_cholesky,
               tlin.cholesky_factor):
        stacked = fn(batch)
        for i in range(2):
            _same(stacked[i], to_np(fn(batch[i])))


@pytest.mark.parametrize("kind, initial_jitter, expected_jitter", [
    ("healthy", None, 0.0),
    ("borderline", 1e-9, 1e-7),
])
def test_robust_cholesky_matches_jax(kind, initial_jitter, expected_jitter):
    a = _matrix(kind)
    chol_t, jitter_t = tlin.robust_cholesky(torch.as_tensor(a), initial_jitter=initial_jitter)
    chol_j, jitter_j = jlin.robust_cholesky(jnp.asarray(a), initial_jitter=initial_jitter)
    assert jitter_t == jitter_j
    np.testing.assert_allclose(jitter_t, expected_jitter, rtol=1e-12)
    assert chol_t.dtype == torch.float64 and chol_t.device.type == "cpu"
    _same(chol_t, chol_j)


def test_robust_cholesky_raises_like_jax():
    a = _matrix("indefinite")
    with pytest.raises(ValueError, match="not PSD") as t_err:
        tlin.robust_cholesky(torch.as_tensor(a))
    with pytest.raises(ValueError, match="not PSD") as j_err:
        jlin.robust_cholesky(jnp.asarray(a))
    assert str(t_err.value) == str(j_err.value)
