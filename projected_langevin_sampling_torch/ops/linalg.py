"""PSD factorisation, multivariate-normal sampling and Cholesky solves
(counterpart of ``projected_langevin_sampling_tpu/ops/linalg.py``).

A constant covariance is factored once (:func:`psd_sqrt`: eigh with the
negative eigenvalues clipped, as reference ``samplers.py:27-29``) and sampled
cheaply afterwards (:func:`sample_with_factor`). Every function but
:func:`robust_cholesky` works on a leading batch dimension too, which the
chunked predict uses in place of the JAX package's ``vmap``. Each sampler
takes pre-drawn standard normals as an alternative to a generator: that is
the parity hook of the tests.

The Cholesky family replaces the reference's ``gpytorch.solve``: a factor is
computed once at basis build and reused. :func:`robust_cholesky` is the
host-side escalating-jitter loop of build time, which raises; the others
never raise and return NaN factors where the input is not positive definite,
as ``jnp.linalg.cholesky`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def psd_sqrt(cov: torch.Tensor) -> torch.Tensor:
    """Factor S with S @ S^T == clip_psd(cov), for (..., M, M)."""
    eigenvalues, eigenvectors = torch.linalg.eigh(cov)
    eigenvalues = torch.clamp_min(eigenvalues, 0.0)
    return eigenvectors * torch.sqrt(eigenvalues)[..., None, :]


def psd_sqrt_host(cov: torch.Tensor) -> torch.Tensor:
    """:func:`psd_sqrt` in host fp64, cast back to ``cov``'s dtype and
    device (build-time factors of fp32 runs)."""
    cov64 = cov.detach().cpu().numpy().astype(np.float64)
    eigenvalues, eigenvectors = np.linalg.eigh(cov64)
    factor = eigenvectors * np.sqrt(np.clip(eigenvalues, 0.0, None))[..., None, :]
    return torch.as_tensor(factor, dtype=cov.dtype, device=cov.device)


def sample_with_factor(
    factor: torch.Tensor,
    size: int,
    mean: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    normals: torch.Tensor | None = None,
) -> torch.Tensor:
    """``size`` samples (..., M, size) = factor @ z (+ mean), z standard
    normal of shape (..., K, size): injected as ``normals`` or drawn from
    ``generator``."""
    if normals is None:
        shape = (*factor.shape[:-2], factor.shape[-1], size)
        normals = torch.randn(
            shape, generator=generator, dtype=factor.dtype, device=factor.device
        )
    samples = factor @ normals
    if mean is not None:
        samples = samples + mean[..., :, None]
    return samples


def sample_multivariate_normal(
    mean: torch.Tensor,
    cov: torch.Tensor,
    size: tuple[int, ...] | int | None = None,
    generator: torch.Generator | None = None,
    normals: torch.Tensor | None = None,
    factor: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-shot MVN samples with negative-eigenvalue clipping, shape
    (*size, M) with samples in rows (reference ``samplers.py:6-44``).
    ``factor`` skips the factorisation; ``normals`` (M, prod(size)) skips the
    draw."""
    if size is None:
        size = (1,)
    if isinstance(size, int):
        size = (size,)
    if factor is None:
        factor = psd_sqrt(cov)
    num = int(np.prod(size))
    samples = sample_with_factor(factor, num, mean=mean, generator=generator, normals=normals)
    return samples.T.reshape(*size, mean.shape[0])


def _cholesky_or_nan(matrix: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., M, M); a matrix that is not positive
    definite gets NaN in the lower triangle instead of an error, as
    ``jnp.linalg.cholesky`` gives."""
    chol, info = torch.linalg.cholesky_ex(matrix)
    failed = (info != 0)[..., None, None]
    return torch.where(failed, torch.tril(torch.full_like(chol, float("nan"))), chol)


def _eye_like(matrix: torch.Tensor) -> torch.Tensor:
    return torch.eye(matrix.shape[-1], dtype=matrix.dtype, device=matrix.device)


def cholesky_factor(matrix: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of ``matrix + jitter I``; NaN where the input is
    not positive definite (it never raises)."""
    if jitter:
        matrix = matrix + jitter * _eye_like(matrix)
    return _cholesky_or_nan(matrix)


def cholesky_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs given the lower Cholesky factor of A."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


def _all_finite(chol: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(chol).all(dim=(-2, -1))[..., None, None]


def psd_safe_cholesky(matrix: torch.Tensor, base_jitter: float, max_tries: int = 3) -> torch.Tensor:
    """gpytorch's escalating-jitter Cholesky as data flow: the factor of
    ``matrix + base_jitter I``, and where it is not finite the first finite
    of ``base_jitter * 10^k``, k = 1..max_tries (per matrix of a batch)."""
    eye = _eye_like(matrix)
    chol = _cholesky_or_nan(matrix + base_jitter * eye)
    for k in range(1, max_tries + 1):
        candidate = _cholesky_or_nan(matrix + (base_jitter * 10.0**k) * eye)
        chol = torch.where(_all_finite(chol), chol, candidate)
    return chol


def nan_rescued_cholesky(
    matrix: torch.Tensor, base_jitter: float = 1e-6, max_tries: int = 5
) -> torch.Tensor:
    """The plain factor where it is finite (bit-identical to a plain
    Cholesky), else the factor at the first finite jitter of
    ``base_jitter * 10^k``, k = 0..max_tries-1; with every candidate NaN, the
    plain factor (NaN). Only the selected jitter's factorisation carries a
    gradient. A healthy input costs one factorisation: the plain factor is
    tried first and returned where every matrix factorises; otherwise the
    probes stop at the first jitter that leaves no matrix unfactored."""
    plain = _cholesky_or_nan(matrix)
    if bool(_all_finite(plain).all()):
        return plain
    eye = _eye_like(matrix)
    probe = matrix.detach()
    jitters = [0.0] + [base_jitter * 10.0**k for k in range(max_tries)]
    found = []  # probes up to the first jitter at which every matrix factorises
    for j in jitters:
        found.append(_all_finite(_cholesky_or_nan(probe + j * eye))[..., 0, 0])
        if bool(torch.stack(found, dim=-1).any(dim=-1).all()):
            break
    ok = torch.stack(found, dim=-1)
    table = torch.tensor(jitters[: len(found)], dtype=matrix.dtype, device=matrix.device)
    selected = table[torch.argmax(ok.to(torch.int8), dim=-1)]  # first finite (0 if none)
    return _cholesky_or_nan(matrix + selected[..., None, None] * eye)


def ladder_cholesky(
    matrix: torch.Tensor, base_jitter: float = 1e-6, max_tries: int = 5
) -> torch.Tensor:
    """:func:`nan_rescued_cholesky` as data flow, reading nothing on the host
    (the JAX package's form): every jitter of the ladder is probed on the
    detached matrix, and the matrix plus the first finite one (0 where the
    plain factor is finite, bit for bit that factor) is factored with its
    gradient. It costs max_tries + 2 factorisations, so the graphed exact-GP
    fit takes it only for a step whose plain factor is not finite."""
    eye = _eye_like(matrix)
    probe = matrix.detach()
    selected = torch.zeros(matrix.shape[:-2], dtype=matrix.dtype, device=matrix.device)
    found = torch.zeros(matrix.shape[:-2], dtype=torch.bool, device=matrix.device)
    for j in [0.0] + [base_jitter * 10.0**k for k in range(max_tries)]:
        ok = _all_finite(_cholesky_or_nan(probe + j * eye))[..., 0, 0]
        selected = torch.where(~found & ok, j, selected)
        found = found | ok
    return _cholesky_or_nan(matrix + selected[..., None, None] * eye)


def robust_cholesky(matrix: torch.Tensor, max_tries: int = 6, initial_jitter: float | None = None):
    """Cholesky with escalating jitter, run on the host in the matrix's dtype
    at build time: the exact factor first, then ``initial_jitter * 10^k``,
    k = 0..max_tries-1, where ``initial_jitter`` defaults to eps times the
    mean absolute diagonal. Returns ``(chol, jitter)`` with the factor on the
    input's device; raises ValueError when no attempt factorises."""
    m = matrix.detach().cpu().numpy()
    if not initial_jitter:  # None or 0.0: a positive floor from the diagonal
        initial_jitter = float(np.finfo(m.dtype).eps) * float(np.mean(np.abs(np.diag(m))))
        if initial_jitter <= 0.0:
            initial_jitter = float(np.finfo(m.dtype).eps)
    jitters = [0.0] + [initial_jitter * 10.0**k for k in range(max_tries)]
    for jitter in jitters:
        try:
            chol = np.linalg.cholesky(m + jitter * np.eye(m.shape[0], dtype=m.dtype))
        except np.linalg.LinAlgError:
            continue
        return torch.as_tensor(chol, device=matrix.device), jitter
    raise ValueError(f"Matrix not PSD even with jitter={jitters[-1]}")
