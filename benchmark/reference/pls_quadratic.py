"""Plain reference of a PLS training run on the inducing-point basis (IPB)
with the Gaussian cost, whose kernel on the ``quadratic_fused`` tier (B4)
draws its Langevin normals itself: the model and the starting particles
rebuilt from the raw inputs and seeds, the normals rebuilt from the call's
seed, and upstream's Euler loop on them.

The model (``basis/inducing_point.py:11-240`` upstream), in fp64 from the raw
inputs: K = k(Z, Z) and D = k(Z, X) by direct differences
(:func:`benchmark.reference.common.ard`); K^-1 through K's Cholesky factor;
the train projection P = k(X, Z) K^-1; the update noise's factor
S = V diag(sqrt(clip(lambda, 0))) from ``numpy.linalg.eigh(K) = (lambda, V)``.
S is the program's convention, not the symmetric square root: any S with
S S^T = K gives the same law, but a particle path depends on the factor, and
so on the sign ``eigh`` gives each column.

The starting particles: ``initialise_particles(J, noise_only=False)`` of the
README's usage, y(Z) + z0 with y(Z) = sin 2Z and z0 one ``torch.randn((M, J))``
in the configuration's dtype from a generator seeded with the start's seed.

The normals. The kernel's 64-bit seed is the first ``torch.randint(0, 2**62,
(1,))`` of the call's generator (:func:`benchmark.reference.pls_philox.philox_seed`).
The normals of update t at row r and columns 4g .. 4g + 3 come from one
Philox4x32-10 call on the counter (g, r, t, 2), the same words, key, uniforms
and Box-Muller pairs as B3's stream 1 (:mod:`benchmark.reference.pls_philox`).

The loop, in upstream's published form (not the program's M-space system
A U - b): for t = 0 .. T - 1,

    F = P U,  dc = (F - y) / s,
    U' = U - eta (D dc + M K^-1 U) + sqrt(2 eta) S eps_t,
    energy_t = mean_j [0.5 ||P U'_j - y||^2 / s + (M / 2) ||K^-1 U'_j||^2].

:func:`train` runs it in fp64; with ``tf32_products`` in fp32 with every
product in one TF32 pass (:func:`benchmark.reference.pls_philox.tf32_product`),
a precision below the configuration's fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.common import ard
from benchmark.reference.pls_philox import (
    MASK32,
    _box_muller,
    no_tf32,
    philox4x32_10,
    tf32_product,
)

# the fourth Philox counter word of B4's draws (B3 draws on 1)
STREAM = 2
# update steps whose normals are drawn at once: 20,000 steps in 79 draws
STEPS_PER_DRAW = 256


class Model(NamedTuple):
    projection: torch.Tensor  # P = k(X, Z) K^-1, (N, M)
    cross: torch.Tensor  # D = k(Z, X), (M, N)
    kinv: torch.Tensor  # K^-1, (M, M)
    noise_factor: torch.Tensor  # S, (M, M)
    y: torch.Tensor  # (N,)
    y_at_z: torch.Tensor  # y(Z) = sin 2Z, (M,)
    noise: float  # the Gaussian cost's variance s


def make_model(x, y, z, lengthscales, outputscale, noise: float) -> Model:
    """The IPB model in fp64 on ``x``'s device."""
    x, y, z = (t.double() for t in (x, y, z))
    lengthscales = torch.as_tensor(lengthscales, dtype=torch.float64, device=x.device)
    outputscale = torch.as_tensor(outputscale, dtype=torch.float64, device=x.device)
    kzz = ard(z, None, lengthscales, outputscale)
    cross = ard(z, x, lengthscales, outputscale)
    chol = torch.linalg.cholesky(kzz)
    lam, v = np.linalg.eigh(kzz.cpu().numpy())
    factor = v * np.sqrt(np.clip(lam, 0.0, None))[None, :]
    return Model(projection=torch.cholesky_solve(cross, chol).T.contiguous(), cross=cross,
                 kinv=torch.cholesky_inverse(chol),
                 noise_factor=torch.as_tensor(factor, dtype=torch.float64, device=x.device),
                 y=y, y_at_z=torch.sin(2.0 * z[:, 0]), noise=float(noise))


def initial_particles(model: Model, j: int, seed: int, dtype) -> torch.Tensor:
    """y(Z) + z0 in fp64, z0 the ``dtype`` normals of a generator seeded with
    ``seed`` on the model's device."""
    device = model.y.device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z0 = torch.randn((model.y_at_z.shape[0], j), generator=gen, dtype=dtype, device=device)
    return model.y_at_z[:, None] + z0.double()


def normals(seed: int, m: int, j: int, first_step: int, steps: int, device) -> torch.Tensor:
    """The normals of updates ``first_step`` .. ``first_step + steps - 1``
    of an (m, j) run of B4 keyed on ``seed``: fp64, (steps, m, j)."""
    groups = (j + 3) // 4
    t = torch.arange(first_step, first_step + steps, dtype=torch.int64, device=device)
    r = torch.arange(m, dtype=torch.int64, device=device)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    x, y, z, w = philox4x32_10((g[None, None, :], r[None, :, None], t[:, None, None], STREAM),
                               (seed & MASK32, seed >> 32))
    z0, z1 = _box_muller(x, y)
    z2, z3 = _box_muller(z, w)
    # column 4 g + q takes entry q of group g
    return torch.stack([z0, z1, z2, z3], dim=-1).reshape(steps, m, 4 * groups)[:, :, :j]


def train(model: Model, u0: torch.Tensor, eta: float, steps: int, seed: int,
          tf32_products: bool = False, noise: torch.Tensor | None = None):
    """``(U, energies)`` after ``steps`` Euler updates from ``u0`` on B4's
    normals of ``seed`` (or on ``noise``, (steps, M, J), where given): fp64
    throughout, or with ``tf32_products`` fp32 with one TF32 pass a
    product."""
    dtype = torch.float32 if tf32_products else torch.float64
    product = tf32_product if tf32_products else torch.matmul
    p, d, kinv, s_mat, y = (t.to(dtype) for t in (model.projection, model.cross, model.kinv,
                                                   model.noise_factor, model.y[:, None]))
    m, j = u0.shape
    root2eta = math.sqrt(2.0 * eta)
    energies = []
    with no_tf32():
        u = u0.to(dtype)
        f = product(p, u)
        ku = product(kinv, u)
        for first in range(0, steps, STEPS_PER_DRAW):
            count = min(STEPS_PER_DRAW, steps - first)
            eps = (normals(seed, m, j, first, count, u.device) if noise is None
                   else noise[first:first + count]).to(dtype)
            for k in range(count):
                dc = (f - y) / model.noise
                u = u - eta * (product(d, dc) + m * ku) + root2eta * product(s_mat, eps[k])
                f, ku = product(p, u), product(kinv, u)
                cost = 0.5 * torch.sum(torch.square(f - y), dim=0) / model.noise
                energies.append(torch.mean(cost + 0.5 * m * torch.sum(ku * ku, dim=0)))
    return u, torch.stack(energies).double().tolist() if energies else []
