"""Langevin training, main-path part (counterpart of
``projected_langevin_sampling_tpu/training.py``).

Tiers for the Euler discretisation (all compute the same posterior):
  "off"       general N-space loop, any cost;
  "quadratic" Gaussian-identity cost: the M-space normal equations,
              the same trajectory as "off" for the same noise;
  "spectral"  ONB + Gaussian-identity: the drift diagonalised once and an
              elementwise recurrence in its eigenbasis, the same law as
              "off". On CUDA tensors this is the hand-written whole-run
              kernel (``ops/cuda/spectral_train.py``); ``"spectral_fused"``
              names the same entry point.

Each tier is a Python loop with the early-stopper carry of the JAX scan: the
stop step's update is applied and its energy written but not recorded, the
particles freeze after it and later energies are NaN. The JAX package's
8 MB VMEM fallback of the fused tier has no counterpart here.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.costs.gaussian import GaussianCost
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.cuda.spectral_train import spectral_train
from projected_langevin_sampling_torch.utils.early_stopper import (
    replay_early_stopper,
    run_with_stopper,
)
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator

_SLICE_2 = "slice 2 of the port (non-Gaussian costs and the general tier)"
_SLICE_3 = "slice 3 of the port (the inducing-point basis)"


def _require_onb(basis) -> None:
    if not isinstance(basis, OrthonormalBasis):
        raise NotImplementedError(
            f"{type(basis).__name__} is not ported yet: it comes with {_SLICE_3}"
        )


def quadratic_fast_path_available(basis, cost) -> bool:
    return isinstance(cost, GaussianCost) and isinstance(cost.link_function, IdentityLinkFunction)


def spectral_fast_path_available(basis, cost) -> bool:
    return quadratic_fast_path_available(basis, cost) and isinstance(basis, OrthonormalBasis)


def resolve_fast_path(basis, cost, fast_path: str) -> str:
    """The tier a fast-path request runs (Euler): "auto" is spectral if
    available, else quadratic, else off; "spectral_fused" is "spectral"."""
    if fast_path == "auto":
        if spectral_fast_path_available(basis, cost):
            return "spectral"
        if quadratic_fast_path_available(basis, cost):
            return "quadratic"
        return "off"
    if fast_path == "general_fused":
        raise NotImplementedError(f"fast_path='general_fused' comes with {_SLICE_2}")
    if fast_path == "quadratic_fused":
        raise NotImplementedError(f"fast_path='quadratic_fused' comes with {_SLICE_3}")
    if fast_path in ("spectral", "spectral_fused"):
        if not spectral_fast_path_available(basis, cost):
            raise ValueError("spectral fast path requires an ONB basis + GaussianCost(identity)")
        return "spectral"
    if fast_path == "quadratic" and not quadratic_fast_path_available(basis, cost):
        raise ValueError("quadratic fast path requires GaussianCost(identity)")
    if fast_path not in ("off", "quadratic"):
        raise ValueError(f"Unknown fast_path {fast_path!r}")
    return fast_path


def resolve_tier(basis, cost, fast_path: str, discretisation: str) -> str:
    """(fast_path, discretisation) -> tier. Only Euler is ported."""
    if discretisation in ("exponential", "preconditioned"):
        raise NotImplementedError(f"discretisation={discretisation!r} comes with {_SLICE_2}")
    if discretisation != "euler":
        raise ValueError(f"Unknown discretisation {discretisation!r}")
    return resolve_fast_path(basis, cost, fast_path)


def _quadratic_system(basis, cost):
    """(A, b, energy_const) of the ONB Gaussian-identity system: the drift is
    A U - b with A = P^T P / s + Lambda^{-1} and b = P^T y / s, and the energy
    0.5 U^T A U - b^T U + energy_const (A and b serve both)."""
    _require_onb(basis)
    p = basis.train_projection
    # c(F + m0, y) == c(F, y - m0) for the identity-link Gaussian cost
    y = cost.y_train - basis.mean_constant if basis.mean_constant else cost.y_train
    s = cost.observation_noise
    a = (p.T @ p) / s + torch.diag(1.0 / basis.eigenvalues)
    b = (p.T @ y) / s
    energy_const = 0.5 * (y @ y) / s
    return a, b, energy_const


class SpectralSystem(NamedTuple):
    """Diagonalised OU system: V = q_in^T U enters the eigenbasis, U = q_out V
    leaves it (q_in == q_out == q for the ONB basis)."""

    sigma: torch.Tensor  # (M,) drift eigenvalues
    q_in: torch.Tensor  # (M, M)
    q_out: torch.Tensor  # (M, M)
    b_rot: torch.Tensor  # (M,) rotated drift and energy bias
    e_const: torch.Tensor  # scalar energy constant


def _spectral_system(basis, cost) -> SpectralSystem:
    """eigh of the drift in the working dtype (Euler, ONB): the update is
    V' = (1 - eta sigma) V + eta b_rot + sqrt(2 eta) eps, the energy
    0.5 sum sigma V^2 - b_rot . V + const."""
    a, b, e_const = _quadratic_system(basis, cost)
    sigma, q = torch.linalg.eigh(a)
    return SpectralSystem(sigma, q, q, q.T @ b, e_const)


def spectral_system_host(basis, cost) -> SpectralSystem:
    """:func:`_spectral_system` with the eigh in host fp64: the N-sized
    contraction runs on the device once, the (M, M) drift goes to the host,
    and the factors come back in the working dtype."""
    a, b, e_const = _quadratic_system(basis, cost)
    a64 = a.detach().cpu().numpy().astype(np.float64)
    b64 = b.detach().cpu().numpy().astype(np.float64)
    sigma64, q64 = np.linalg.eigh(a64)
    back = lambda v: torch.as_tensor(v, dtype=a.dtype, device=a.device)  # noqa: E731
    q = back(q64)
    return SpectralSystem(back(sigma64), q, q, back(q64.T @ b64), e_const)


_replay_early_stopper = replay_early_stopper


class TrainResult(NamedTuple):
    particles: torch.Tensor  # (M, J) final particles
    energies: torch.Tensor  # (T,) energy per step, NaN once stopped
    recorded: torch.Tensor  # (T,) bool, True where the reference would append
    steps_run: torch.Tensor  # scalar int, steps executed before stopping


def _noise_source(noise, generator, shape, dtype, device):
    if noise is not None:
        return lambda t: noise[t]
    return lambda t: torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _train_pls_loop(
    basis,
    cost,
    particles: torch.Tensor,
    step_size: float,
    patience: float,
    number_of_epochs: int,
    tier: str,
    spectral_system: SpectralSystem | None = None,
    generator: GeneratorLike = None,
    noise: torch.Tensor | None = None,
) -> TrainResult:
    """Run one tier for ``number_of_epochs`` steps (Euler).

    ``noise`` (T, M_k, J) injects the U-space update noise of every step
    (the parity hook; CPU tensors only on the spectral tier, where it is
    rotated into the eigenbasis); otherwise noise comes from ``generator``."""
    _require_onb(basis)
    dtype, device = particles.dtype, particles.device
    generator = as_generator(generator, device=device)
    eta = float(step_size)
    root2eta = math.sqrt(2.0 * eta)

    if tier == "spectral":
        sigma, q_in, q_out, b_rot, e_const = (
            spectral_system if spectral_system is not None else _spectral_system(basis, cost)
        )
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=device))
        w, energies, recorded, steps_run = spectral_train(
            q_in.T @ particles,
            1.0 - eta * sigma,
            eta * b_rot,
            sigma,
            b_rot,
            eta=eta,
            patience=patience,
            e_const=e_const,
            num_steps=number_of_epochs,
            noise_scale=root2eta,
            seed=seed,
            noise=noise,
            q_in=q_in,
            generator=generator,
        )
        return TrainResult(q_out @ w, energies, recorded, steps_run)

    draw = _noise_source(noise, generator, particles.shape, dtype, device)
    if tier == "quadratic":
        a_mat, b_vec, e_const = _quadratic_system(basis, cost)

        def step(t, state):
            # v carries A u: one matmul per step serves this step's drift and
            # the previous update's energy
            u, v = state
            u_new = u - eta * (v - b_vec[:, None]) + root2eta * draw(t)
            v_new = a_mat @ u_new
            energy_j = 0.5 * torch.sum(u_new * v_new, dim=0) - b_vec @ u_new + e_const
            return (u_new, v_new), torch.mean(energy_j)

        state0 = (particles, a_mat @ particles)
    elif tier == "off":

        def step(t, state):
            # carries F = P U: the F of this step's energy is the next step's
            # derivative input
            u, pred = state
            dc = cost.calculate_cost_derivative(pred)
            u_new = u + basis._calculate_particle_update(u, dc, eta, draw(t))
            pred_new = basis.calculate_untransformed_train_prediction_samples(u_new)
            energy = basis.calculate_energy_potential(u_new, cost.calculate_cost(pred_new))
            return (u_new, pred_new), energy

        state0 = (particles, basis.calculate_untransformed_train_prediction_samples(particles))
    else:
        raise ValueError(f"Unknown tier {tier!r}")
    state, energies, recorded, steps_run = run_with_stopper(
        step, state0, number_of_epochs, eta, patience, dtype, device
    )
    return TrainResult(state[0], energies, recorded, steps_run)


def _train_pls_chunked(*args, **kwargs):
    """The JAX package's runner of very long runs in bounded programs. Here
    :func:`train_pls` runs any length as one loop, and the spectral kernel
    launches in pieces itself."""
    raise NotImplementedError(
        "_train_pls_chunked comes with slice 5 of the port (scale-out and harness)"
    )


def train_pls(
    pls: PLS,
    particles: torch.Tensor,
    number_of_epochs: int,
    step_size: float,
    early_stopper_patience: float = float("inf"),
    generator: GeneratorLike = None,
    seed: int | None = None,
    fast_path: str = "auto",
    discretisation: str = "euler",
) -> tuple[torch.Tensor, list[float]]:
    """Train PLS particles; returns (particles, recorded energy potentials)
    like reference ``experiments/trainers.py:139-162``. The spectral tier's
    factorisation runs in host fp64; very long runs are one loop (the JAX
    package's chunked runner has no counterpart here)."""
    if generator is None and seed is not None:
        generator = seed
    basis, cost = pls.basis, pls.cost
    tier = resolve_tier(basis, cost, fast_path, discretisation)
    if fast_path == "auto" and generator is not None and tier == "spectral":
        warnings.warn(
            'fast_path="auto" resolved to the spectral tier: identical '
            "posterior law, but a given seed yields a different sample path "
            'than fast_path="quadratic"/"off".',
            UserWarning,
            stacklevel=2,
        )
    result = _train_pls_loop(
        basis,
        cost,
        particles,
        step_size,
        early_stopper_patience,
        int(number_of_epochs),
        tier,
        spectral_system_host(basis, cost) if tier == "spectral" else None,
        generator=generator,
    )
    energies = [
        float(e) for e, r in zip(result.energies.tolist(), result.recorded.tolist()) if r
    ]
    return result.particles, energies
