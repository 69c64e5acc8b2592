"""Langevin training (counterpart of ``projected_langevin_sampling_tpu/training.py``).

Tiers (all compute the same posterior):
  "off"           general N-space loop, any cost, every discretisation;
  "quadratic"     Gaussian-identity cost: the M-space normal equations, the
                  same trajectory as "off" for the same noise (Euler);
  "spectral"      ONB + Gaussian-identity: the drift diagonalised once and an
                  elementwise recurrence in its eigenbasis, the same law as
                  "off" (Euler, preconditioned). On CUDA tensors this is the
                  hand-written whole-run kernel B1 (``ops/cuda/spectral_train.py``);
                  ``"spectral_fused"`` names the same entry point;
  "general_fused" ONB + a cost with a closed form in the general kernel
                  (:func:`general_fused_cost_spec`): on CUDA tensors the
                  hand-written whole-run kernel B3 (``ops/cuda/general_train.py``),
                  every discretisation.

Discretisations: "euler" (the reference's), and the ONB split schemes
"exponential" (the prior drift and its noise integrated exactly) and
"preconditioned" (Lambda-preconditioned Langevin with the exact OU prior
step), as in the JAX package (``training.py:871-956``).

Each tier has the early-stopper carry of the JAX scan: the stop step's update
is applied and its energy written but not recorded, the particles freeze
after it and later energies are NaN. The JAX package's VMEM fallbacks of the
fused tiers (``training.py:237-242, 250-253``) have no counterpart: neither
kernel here has a resident-size limit, so a fused request is never
downgraded for size.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    GaussianCost,
    MultiModalCost,
    PoissonCost,
    SmoothedBernoulliCost,
    StudentTCost,
)
from projected_langevin_sampling_torch.models.link_functions import (
    IdentityLinkFunction,
    ProbitLinkFunction,
    SigmoidLinkFunction,
    SquareLinkFunction,
)
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.cuda.general_train import (
    GH16_NODES,
    GH16_WEIGHTS,
    general_train,
    split_row_constants,
)
from projected_langevin_sampling_torch.ops.cuda.spectral_train import spectral_train
from projected_langevin_sampling_torch.utils.early_stopper import (
    replay_early_stopper,
    run_with_stopper,
)
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator

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


# Tiers implementing each non-Euler discretisation's recurrence
# (``training.py:103-106`` of the JAX package).
NON_EULER_TIERS = {
    "exponential": ("off", "general_fused"),
    "preconditioned": ("off", "general_fused", "spectral", "spectral_fused"),
}
DISCRETISATIONS = ("euler", "exponential", "preconditioned")


def _is_gh16_rule(cost) -> bool:
    """True when the cost's (gh_nodes, gh_weights) is numerically the
    physicists' hermgauss(16) rule that the general kernel applies (rtol
    covers an fp32 cast; atol 0 so the 2.6e-10 weights compare relatively).
    Always a numeric check: a torch tensor is never abstract."""
    nodes = cost.gh_nodes.detach().cpu().numpy()
    weights = cost.gh_weights.detach().cpu().numpy()
    return bool(
        nodes.shape == GH16_NODES.shape
        and np.allclose(nodes, GH16_NODES, rtol=1e-5, atol=0)
        and np.allclose(weights, GH16_WEIGHTS, rtol=1e-5, atol=0)
    )


def _precond_spectral_coeffs(step_size: float, sigma: torch.Tensor, b_rot: torch.Tensor):
    """Coefficients of the preconditioned spectral recurrence
    W' = decay W + shift + noise_scale eps (see :func:`_spectral_system`)."""
    exp_decay = math.exp(-step_size)
    decay = exp_decay * (1.0 - step_size * sigma)
    shift = exp_decay * step_size * b_rot
    noise_scale = math.sqrt(-math.expm1(-2.0 * step_size))
    return decay, shift, noise_scale


def general_fused_cost_spec(basis, cost):
    """``(cost_kind, p0, p1, p2, aux)`` for the general kernel, or None when
    the (basis, cost, link) combination has no closed form there. ``aux`` is
    the per-row residual smoothing std or None."""
    if not isinstance(basis, OrthonormalBasis):
        return None
    link = cost.link_function
    if isinstance(cost, GaussianCost) and isinstance(link, IdentityLinkFunction):
        return ("gaussian", float(cost.observation_noise), 0.0, 0.0, None)
    if isinstance(cost, BernoulliCost) and isinstance(link, SigmoidLinkFunction) and (
        link.jitter == 1e-10  # the kernel applies the library default
    ):
        return ("bernoulli_sigmoid", 0.0, 0.0, 0.0, None)
    if (
        isinstance(cost, SmoothedBernoulliCost)
        and isinstance(link, SigmoidLinkFunction)
        # the kernel applies hermgauss(16); any other rule stays on "off", or
        # the two tiers would train different costs
        and _is_gh16_rule(cost)
    ):
        return ("bernoulli_sigmoid_smoothed", 0.0, 0.0, 0.0, cost.smoothing_std)
    if isinstance(cost, BernoulliCost) and isinstance(link, ProbitLinkFunction) and (
        link.jitter == 1e-10
    ):
        return ("bernoulli_probit", 0.0, 0.0, 0.0, None)
    if isinstance(cost, PoissonCost) and isinstance(link, SquareLinkFunction):
        return ("poisson_square", 0.0, 0.0, 0.0, None)
    if isinstance(cost, StudentTCost) and isinstance(link, IdentityLinkFunction):
        return ("student_t", float(cost.degrees_of_freedom), float(cost.scale), 0.0, None)
    if isinstance(cost, MultiModalCost) and isinstance(link, IdentityLinkFunction):
        # the closed-form responsibility-weighted gradient (the cost itself
        # trains by autograd, as in the reference)
        return (
            "multimodal_identity",
            float(cost.observation_noise),
            float(cost.shift),
            float(cost.bernoulli_noise),
            None,
        )
    return None


def resolve_fast_path(basis, cost, fast_path: str) -> str:
    """The tier a fast-path request runs (Euler): "auto" is spectral if
    available, else quadratic, else off; "spectral_fused" is "spectral";
    "general_fused" is "off" for a cost without a closed form in the kernel
    (the JAX package's rule, ``training.py:248-249``)."""
    if fast_path == "auto":
        if spectral_fast_path_available(basis, cost):
            return "spectral"
        if quadratic_fast_path_available(basis, cost):
            return "quadratic"
        return "off"
    if fast_path == "general_fused":
        return "off" if general_fused_cost_spec(basis, cost) is None else "general_fused"
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
    """(fast_path, discretisation) -> tier, as ``training.py:271-306`` of the
    JAX package with ``strict=True``: a combination no tier implements
    raises. (Its ``strict=False`` serves ``langevin_steps``, slice 5.)"""
    if discretisation == "euler":
        return resolve_fast_path(basis, cost, fast_path)
    if discretisation not in NON_EULER_TIERS:
        raise ValueError(f"Unknown discretisation {discretisation!r}")
    allowed = NON_EULER_TIERS[discretisation]
    if fast_path == "auto":
        return (
            "spectral"
            if discretisation == "preconditioned" and spectral_fast_path_available(basis, cost)
            else "off"
        )
    if fast_path in allowed:
        return resolve_fast_path(basis, cost, fast_path)
    raise ValueError(
        f"fast_path={fast_path!r} does not implement "
        f"discretisation={discretisation!r} (allowed: {allowed} or 'auto')"
    )


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


def _precond_system64(basis, cost):
    """The preconditioned system in fp64 numpy: the Lambda-preconditioned
    chain U' = e^-eta (U - eta Lambda (A_d U - b)) + sqrt(lambda (1 - e^-2eta)) eps
    is diagonalised by C = Lambda^1/2 (P^T P / s) Lambda^1/2 = Q S Q^T, and
    W = Q^T Lambda^-1/2 U has iid noise."""
    _require_onb(basis)
    to64 = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    p64 = to64(basis.train_projection)
    y64 = to64(cost.y_train) - basis.mean_constant  # exact for the identity-link Gaussian
    s_noise = float(cost.observation_noise)
    root_lam = np.sqrt(to64(basis.eigenvalues))
    p_half = p64 * root_lam[None, :]
    sigma, q = np.linalg.eigh((p_half.T @ p_half) / s_noise)
    b_rot = q.T @ (root_lam * (p64.T @ y64 / s_noise))
    q_in = (1.0 / root_lam)[:, None] * q  # W = q_in^T U
    q_out = root_lam[:, None] * q  # U = q_out W
    return sigma, q_in, q_out, b_rot, 0.5 * (y64 @ y64) / s_noise


def _spectral_system(basis, cost, discretisation: str = "euler") -> SpectralSystem:
    """Diagonalise the OU drift (ONB).

    euler: eigh of A in the working dtype; the update is
    V' = (1 - eta sigma) V + eta b_rot + sqrt(2 eta) eps and the energy
    0.5 sum sigma V^2 - b_rot . V + const.
    preconditioned: ``sigma`` is the data-only spectrum S of
    :func:`_precond_system64`; the energy in W is
    0.5 sum (S + 1) W^2 - b_rot . W + const. Its factorisation always runs in
    host fp64, as in the JAX package's host path."""
    if discretisation == "preconditioned":
        return spectral_system_host(basis, cost, discretisation)
    a, b, e_const = _quadratic_system(basis, cost)
    sigma, q = torch.linalg.eigh(a)
    return SpectralSystem(sigma, q, q, q.T @ b, e_const)


def spectral_system_host(basis, cost, discretisation: str = "euler") -> SpectralSystem:
    """:func:`_spectral_system` with the factorisation in host fp64: for
    Euler the N-sized contraction runs on the device once and the (M, M)
    drift goes to the host; the factors come back in the working dtype."""
    if discretisation == "preconditioned":
        dtype, device = basis.train_projection.dtype, basis.train_projection.device
        back = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
        return SpectralSystem(*(back(v) for v in _precond_system64(basis, cost)))
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
    discretisation: str = "euler",
) -> TrainResult:
    """Run one tier for ``number_of_epochs`` steps.

    ``noise`` (T, M_k, J) injects the standard normals of every step in U
    coordinates, the ``eps`` of the off tier's update (the parity hook; CPU
    tensors only on the spectral and general_fused tiers; the spectral tier
    rotates it into its eigenbasis); otherwise noise comes from
    ``generator``."""
    _require_onb(basis)
    if discretisation not in DISCRETISATIONS:
        raise ValueError(f"Unknown discretisation {discretisation!r}")
    if discretisation != "euler" and tier not in NON_EULER_TIERS[discretisation]:
        raise ValueError(
            f"discretisation={discretisation!r} is not implemented for the {tier!r} tier "
            f"(allowed: {NON_EULER_TIERS[discretisation]})"
        )
    dtype, device = particles.dtype, particles.device
    generator = as_generator(generator, device=device)
    eta = float(step_size)
    root2eta = math.sqrt(2.0 * eta)

    if tier in ("spectral", "general_fused"):
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=device))
    if tier == "spectral":
        sigma, q_in, q_out, b_rot, e_const = (
            spectral_system
            if spectral_system is not None
            else _spectral_system(basis, cost, discretisation)
        )
        if discretisation == "preconditioned":
            decay, shift, noise_scale = _precond_spectral_coeffs(eta, sigma, b_rot)
            energy_sigma = sigma + 1.0
            # U-space normals enter W through the orthogonal factor Q
            q_noise = torch.sqrt(basis.eigenvalues.to(dtype))[:, None] * q_in
        else:
            decay, shift, noise_scale = 1.0 - eta * sigma, eta * b_rot, root2eta
            energy_sigma, q_noise = sigma, q_in
        w, energies, recorded, steps_run = spectral_train(
            q_in.T @ particles,
            decay,
            shift,
            energy_sigma,
            b_rot,
            eta=eta,
            patience=patience,
            e_const=e_const,
            num_steps=number_of_epochs,
            noise_scale=noise_scale,
            seed=seed,
            noise=noise,
            q_in=q_noise,
            generator=generator,
        )
        return TrainResult(q_out @ w, energies, recorded, steps_run)
    if tier == "general_fused":
        kind, p0, p1, p2, aux = general_fused_cost_spec(basis, cost)
        return TrainResult(*general_train(
            basis.train_projection,
            particles,
            cost.y_train,
            basis.eigenvalues,
            kind,
            eta=eta,
            patience=patience,
            num_steps=number_of_epochs,
            params=(p0, p1, p2),
            mean_shift=basis.mean_constant,
            aux=aux,
            discretisation=discretisation,
            seed=seed,
            noise=noise,
            generator=generator,
        ))

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
        if discretisation == "euler":

            def update(u, dc, t):
                return u + basis._calculate_particle_update(u, dc, eta, draw(t))

        else:
            # split schemes: explicit data sub-step, then the exact OU flow of
            # the prior and its noise, U' = dec (U - eta ds P^T dc) + nscale eps
            _, dec, ds, nscale = (
                c[:, None] for c in split_row_constants(basis.eigenvalues.to(dtype), eta,
                                                        discretisation)
            )
            projection = basis.train_projection

            def update(u, dc, t):
                return dec * (u - eta * (ds * (projection.T @ dc))) + nscale * draw(t)

        def step(t, state):
            # carries F = P U: the F of this step's energy is the next step's
            # derivative input
            u, pred = state
            u_new = update(u, cost.calculate_cost_derivative(pred), t)
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
    like reference ``experiments/trainers.py:139-162``.

    ``fast_path`` selects the tier (:func:`resolve_tier`); ``discretisation``
    is "euler" (the reference's scheme, every tier), "exponential" (off,
    general_fused) or "preconditioned" (off, general_fused, spectral; "auto"
    takes the spectral tier for a Gaussian-identity cost, else off). The
    spectral tier's factorisation runs in host fp64; very long runs are one
    loop (the JAX package's chunked runner has no counterpart here)."""
    if generator is None and seed is not None:
        generator = seed
    basis, cost = pls.basis, pls.cost
    _require_onb(basis)
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
        spectral_system_host(basis, cost, discretisation) if tier == "spectral" else None,
        generator=generator,
        discretisation=discretisation,
    )
    energies = [
        float(e) for e, r in zip(result.energies.tolist(), result.recorded.tolist()) if r
    ]
    return result.particles, energies
