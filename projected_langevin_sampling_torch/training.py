"""Langevin training (counterpart of ``projected_langevin_sampling_tpu/training.py``).

Tiers (all compute the same posterior):
  "off"             general N-space loop, any cost, both bases (the split
                    discretisations on the ONB only); a step takes the
                    cost and its derivative of one F in one call
                    (``calculate_cost_and_derivative``), which for the
                    smoothed Bernoulli cost on CUDA tensors is one pass of
                    the hand-written kernel ``ops/cuda/smoothed_bernoulli.py``;
  "quadratic"       Gaussian-identity cost: the M-space normal equations, the
                    same trajectory as "off" for the same noise (Euler);
  "quadratic_fused" the quadratic tier as one whole run: on CUDA tensors the
                    hand-written kernel B4 (``ops/cuda/quadratic_train.py``),
                    shared (ONB: one product per step) or not (IPB: three);
  "spectral"        ONB or IPB + Gaussian-identity: the drift diagonalised
                    once (for the IPB after the change of variables
                    W = S^{-1} U) and an elementwise recurrence in its
                    eigenbasis, the same law as "off" (Euler, preconditioned).
                    On CUDA tensors this is the whole-run kernel B1
                    (``ops/cuda/spectral_train.py``); ``"spectral_fused"``
                    names the same entry point;
  "general_fused"   ONB + a cost with a closed form in the general kernel
                    (``closed_forms.py``): on CUDA tensors the
                    whole-run kernel B3 (``ops/cuda/general_train.py``), every
                    discretisation.

Discretisations: "euler" (the reference's), and the ONB split schemes
"exponential" (the prior drift and its noise integrated exactly) and
"preconditioned" (Lambda-preconditioned Langevin with the exact OU prior
step), as in the JAX package (``training.py:871-956``). :func:`train_pls`
runs an IPB model under a split scheme or ``general_fused`` in its exact
W-space ONB view (:func:`ipb_w_space_view`) and maps the particles back.

Each tier of :func:`train_pls` has the early-stopper carry of the JAX scan:
the stop step's update is applied and its energy written but not recorded,
the particles freeze after it and later energies are NaN. The ``off`` and
``quadratic`` tiers carry it on the device through
``utils/early_stopper.run_training``: on the card one step is a captured
CUDA graph, replayed in chunks, the counterpart of the JAX package's scan
(``training.py:687``, ``_train_pls_scan``). The JAX package's
VMEM fallbacks of the fused tiers (``training.py:237-242, 250-253``) have no
counterpart: no kernel here has a resident-size limit, so a fused request is
never downgraded for size.

:func:`langevin_steps` is the throughput path: steps with no energy and no
stopping. Its Euler general body is one launch of the fused-update kernel B5
(``ops/cuda/fused_update.py``) per step on CUDA tensors for a cost with a
closed form there (``closed_forms.dc_kind_for_cost``).
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from projected_langevin_sampling_torch.models.basis.inducing_point import InducingPointBasis
from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.closed_forms import dc_kind_for_cost, general_fused_form
from projected_langevin_sampling_torch.models.costs import GaussianCost
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.cuda.fused_update import fused_update
from projected_langevin_sampling_torch.ops.cuda.general_train import (
    general_train,
    split_row_constants,
)
from projected_langevin_sampling_torch.ops.cuda.quadratic_train import quadratic_train
from projected_langevin_sampling_torch.ops.cuda.spectral_train import spectral_train
from projected_langevin_sampling_torch.utils.columns import ColumnShard, column_mean, column_normals
from projected_langevin_sampling_torch.utils.early_stopper import (
    NoiseChunks,
    replay_early_stopper,
    run_training,
    take,
)
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator
from projected_langevin_sampling_torch.utils.tracing import span

def _require_known_basis(basis) -> None:
    if not isinstance(basis, (OrthonormalBasis, InducingPointBasis)):
        raise TypeError(f"No training path for {type(basis).__name__}")


def quadratic_fast_path_available(basis, cost) -> bool:
    return isinstance(cost, GaussianCost) and isinstance(cost.link_function, IdentityLinkFunction)


def spectral_fast_path_available(basis, cost) -> bool:
    """ONB: the drift is symmetric and the noise iid. IPB: the process is a
    K(Z,Z)-preconditioned Langevin, and W = S^{-1} U (S S^T = K(Z,Z), the
    basis's noise factor) makes the drift symmetric and the noise iid
    (``training.py:67-97`` of the JAX package)."""
    return quadratic_fast_path_available(basis, cost) and isinstance(
        basis, (OrthonormalBasis, InducingPointBasis)
    )


# Tiers implementing each non-Euler discretisation's recurrence
# (``training.py:103-106`` of the JAX package).
NON_EULER_TIERS = {
    "exponential": ("off", "general_fused"),
    "preconditioned": ("off", "general_fused", "spectral", "spectral_fused"),
}
DISCRETISATIONS = ("euler", "exponential", "preconditioned")


def _precond_spectral_coeffs(step_size: float, sigma: torch.Tensor, b_rot: torch.Tensor):
    """Coefficients of the preconditioned spectral recurrence
    W' = decay W + shift + noise_scale eps (see :func:`_spectral_system`)."""
    exp_decay = math.exp(-step_size)
    decay = exp_decay * (1.0 - step_size * sigma)
    shift = exp_decay * step_size * b_rot
    noise_scale = math.sqrt(-math.expm1(-2.0 * step_size))
    return decay, shift, noise_scale


def resolve_fast_path(basis, cost, fast_path: str) -> str:
    """The tier a fast-path request runs (Euler): "auto" is spectral if
    available, else quadratic, else off; "spectral_fused" is "spectral";
    "general_fused" is "off" for a basis and cost without a closed form in the
    kernel (the JAX package's rule, ``training.py:248-249``); "quadratic" and
    "quadratic_fused" need the Gaussian-identity cost (``:261-264``)."""
    if fast_path == "auto":
        if spectral_fast_path_available(basis, cost):
            return "spectral"
        if quadratic_fast_path_available(basis, cost):
            return "quadratic"
        return "off"
    if fast_path == "general_fused":
        return "off" if general_fused_form(basis, cost) is None else "general_fused"
    if fast_path in ("spectral", "spectral_fused"):
        if not spectral_fast_path_available(basis, cost):
            raise ValueError(
                "spectral fast path requires an ONB or IPB basis + GaussianCost(identity)"
            )
        return "spectral"
    if fast_path in ("quadratic", "quadratic_fused") and not quadratic_fast_path_available(
        basis, cost
    ):
        raise ValueError("quadratic fast path requires GaussianCost(identity)")
    if fast_path not in ("off", "quadratic", "quadratic_fused"):
        raise ValueError(f"Unknown fast_path {fast_path!r}")
    return fast_path


def resolve_tier(basis, cost, fast_path: str, discretisation: str, strict: bool = True) -> str:
    """(fast_path, discretisation) -> tier, as ``training.py:271-306`` of the
    JAX package: with ``strict`` a combination no tier implements raises;
    without (:func:`langevin_steps`) it falls to "off"."""
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
    if not strict:
        return "off"
    raise ValueError(
        f"fast_path={fast_path!r} does not implement "
        f"discretisation={discretisation!r} (allowed: {allowed} or 'auto')"
    )


def needs_w_space_reroute(basis, fast_path: str, discretisation: str) -> bool:
    """True when an IPB model trains in its exact W-space ONB view
    (:func:`ipb_w_space_view`): the general kernel and every non-Euler
    discretisation are ONB-only (``training.py:309-320`` of the JAX package)."""
    return isinstance(basis, InducingPointBasis) and (
        discretisation != "euler" or fast_path == "general_fused"
    )


def _quadratic_system(basis, cost):
    """``(A, b, E, e_bias, e_const, shared)`` of the Gaussian-identity system:
    the drift is A U - b and the energy 0.5 U^T E U - e_bias . U + e_const
    (``training.py:323-360`` of the JAX package).

    ONB: A = E = P^T P / s + Lambda^{-1}, b = e_bias = P^T y / s (shared).
    IPB: with D = k(X, Z), A = D^T P / s + M K^{-1}, b = D^T y / s,
    E = P^T P / s + M K^{-2}, e_bias = P^T y / s (not shared)."""
    p = basis.train_projection
    # c(F + m0, y) == c(F, y - m0) for the identity-link Gaussian cost
    y = cost.y_train - basis.mean_constant if basis.mean_constant else cost.y_train
    s = cost.observation_noise
    pt_p, pt_y = p.T @ p, p.T @ y
    if isinstance(basis, OrthonormalBasis):
        a = pt_p / s + torch.diag(1.0 / basis.eigenvalues)
        b, e_mat, shared = pt_y / s, a, True
    elif isinstance(basis, InducingPointBasis):
        k_zx = basis.base_gram_induce_train  # D^T
        m = basis.approximation_dimension
        kinv = basis.inv_base_gram_induce
        a = (k_zx @ p) / s + m * kinv
        b = (k_zx @ y) / s
        e_mat, shared = pt_p / s + m * (kinv @ kinv), False
    else:
        raise TypeError(f"No quadratic fast path for {type(basis).__name__}")
    return a, b, e_mat, pt_y / s, 0.5 * (y @ y) / s, shared


class SpectralSystem(NamedTuple):
    """Diagonalised OU system: V = q_in^T U enters the eigenbasis, U = q_out V
    leaves it (q_in == q_out == q for the ONB basis; for the IPB
    q_in = S^{-T} q and q_out = S q)."""

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
    if not isinstance(basis, OrthonormalBasis):
        raise ValueError(
            "preconditioned spectral system requires the ONB basis "
            "(route IPB through its W-space ONB view first)"
        )
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


def _w_space_system(a, b, lam, v, eigh):
    """The IPB system after W = S^{-1} U with S = V lam^{1/2}: S^{-1} A S,
    symmetric in exact arithmetic, diagonalised by ``eigh``; returns
    (sigma, q_in, q_out, b_rot) in the inputs' library (torch or numpy)."""
    root = lam**0.5
    s = v * root[None, :]
    s_inv = (1.0 / root)[:, None] * v.T
    a_w = s_inv @ a @ s
    sigma, q = eigh(0.5 * (a_w + a_w.T))
    return sigma, s_inv.T @ q, s @ q, q.T @ (s_inv @ b)


def _spectral_system(basis, cost, discretisation: str = "euler") -> SpectralSystem:
    """Diagonalise the OU drift in the working dtype.

    euler, ONB: eigh of A; the update is
    V' = (1 - eta sigma) V + eta b_rot + sqrt(2 eta) eps and the energy
    0.5 sum sigma V^2 - b_rot . V + const. euler, IPB: the same after
    W = S^{-1} U, with k(Z,Z)'s eigenvalues floored at eps lam_max
    (``training.py:438-452`` of the JAX package).
    preconditioned (ONB): ``sigma`` is the data-only spectrum S of
    :func:`_precond_system64`; the energy in W is
    0.5 sum (S + 1) W^2 - b_rot . W + const. Its factorisation always runs in
    host fp64, as in the JAX package's host path."""
    if discretisation == "preconditioned":
        return spectral_system_host(basis, cost, discretisation)
    a, b, _, _, e_const, _ = _quadratic_system(basis, cost)
    if isinstance(basis, OrthonormalBasis):
        sigma, q = torch.linalg.eigh(a)
        return SpectralSystem(sigma, q, q, q.T @ b, e_const)
    lam, v = torch.linalg.eigh(basis.base_gram_induce)
    lam = torch.clamp_min(lam, torch.finfo(lam.dtype).eps * lam[-1])
    return SpectralSystem(*_w_space_system(a, b, lam, v, torch.linalg.eigh), e_const)


def spectral_system_host(basis, cost, discretisation: str = "euler") -> SpectralSystem:
    """:func:`_spectral_system` with the factorisation in host fp64: for
    Euler the N-sized contractions run on the device once and the (M, M)
    matrices go to the host; the factors come back in the working dtype. An
    IPB k(Z,Z) with eigenvalues below eps lam_max is clamped, with a warning
    (``training.py:514-539`` of the JAX package)."""
    if discretisation == "preconditioned":
        dtype, device = basis.train_projection.dtype, basis.train_projection.device
        back = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
        return SpectralSystem(*(back(v) for v in _precond_system64(basis, cost)))
    a, b, _, _, e_const, _ = _quadratic_system(basis, cost)
    to64 = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    back = lambda v: torch.as_tensor(v, dtype=a.dtype, device=a.device)  # noqa: E731
    a64, b64 = to64(a), to64(b)
    if isinstance(basis, OrthonormalBasis):
        sigma64, q64 = np.linalg.eigh(a64)
        q = back(q64)
        return SpectralSystem(back(sigma64), q, q, back(q64.T @ b64), e_const)
    lam, v = np.linalg.eigh(to64(basis.base_gram_induce))
    floor = np.finfo(np.float64).eps * lam[-1]
    clamped = int(np.sum(lam < floor))
    if clamped:
        warnings.warn(
            f"IPB spectral tier: {clamped} eigenvalues of k(Z,Z) below eps*lam_max were "
            "clamped; the W-space system is no longer an exact similarity transform of "
            "the drift, and the spectral law can deviate from the quadratic and general "
            "tiers beyond fp noise. Consider fast_path='quadratic'.",
            stacklevel=2,
        )
    system64 = _w_space_system(a64, b64, np.maximum(lam, floor), v, np.linalg.eigh)
    return SpectralSystem(*(back(t) for t in system64), e_const)


def ipb_w_space_view(basis: InducingPointBasis):
    """ONB-shaped view of the IPB training process, ``(view, s, s_inv)``
    with W0 = s_inv @ U0 and U = s @ W (``training.py:549-600`` of the JAX
    package).

    The IPB process is the k(Z,Z)-preconditioned Langevin of
    E(U) = cost(P U) + (M/2) ||K^{-1} U||^2. With eigh((1/M) k(Z,Z)) =
    (lam_hat, V) and S = V diag(sqrt(M lam_hat)), the basis's own noise
    factor, W = S^{-1} U is the standard Langevin of an ONB potential: train
    projection k(X,Z) V / sqrt(M lam_hat), prior eigenvalues lam_hat, iid
    noise, and the same energies. The Euler chains agree exactly: U_t = S W_t
    for the same normals z. Factorisations in host fp64."""
    dtype, device = basis.dtype, basis.device
    kzz64 = basis.base_gram_induce.detach().cpu().numpy().astype(np.float64)
    m = kzz64.shape[0]
    lam_hat, v = np.linalg.eigh(kzz64 / m)
    lam_hat = np.maximum(lam_hat, np.finfo(np.float64).eps * lam_hat[-1])
    root = np.sqrt(m * lam_hat)
    scaled_eigenvectors = v / root[None, :]  # the reference scaling with M_k = M
    kzx64 = basis.base_gram_induce_train.detach().cpu().numpy().astype(np.float64)
    back = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    view = OrthonormalBasis(
        kernel=basis.kernel,
        x_induce=basis.x_induce,
        eigenvalues=back(lam_hat),
        scaled_eigenvectors=back(scaled_eigenvectors),
        base_gram_induce_train=basis.base_gram_induce_train,
        train_projection=back(kzx64.T @ scaled_eigenvectors),
        scaling="reference",
        mean_constant=basis.mean_constant,
    )
    return view, back(v * root[None, :]), back((1.0 / root)[:, None] * v.T)


_replay_early_stopper = replay_early_stopper


class TrainResult(NamedTuple):
    particles: torch.Tensor  # (M, J) final particles
    energies: torch.Tensor  # (T,) energy per step, NaN once stopped
    recorded: torch.Tensor  # (T,) bool, True where the reference would append
    steps_run: torch.Tensor  # scalar int, steps executed before stopping


def _update_noise(basis, noise, generator, number_of_particles: int,
                  shard: ColumnShard | None = None):
    """Step t's update noise, the basis's S z (z itself on the ONB): z is
    ``noise[t]`` when injected, else drawn from ``generator`` (a shard's
    columns of the whole run's draw)."""
    if noise is None and shard is not None:
        shape = (basis.approximation_dimension, number_of_particles)
        return lambda t: basis.sample_update_noise(number_of_particles, normals=column_normals(
            shape, generator, basis.dtype, basis.device, shard))
    return lambda t: basis.sample_update_noise(
        number_of_particles, generator, normals=None if noise is None else take(noise, t)
    )


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
    shard: ColumnShard | None = None,
) -> TrainResult:
    """Run one tier for ``number_of_epochs`` steps.

    ``noise`` (T, M, J) injects the standard normals z of every step, the
    draws of the basis's update noise (the noise itself on the ONB, S z on
    the IPB): the parity hook, CPU tensors only on the fused tiers; the
    spectral tier rotates it into its eigenbasis. A
    :class:`~projected_langevin_sampling_torch.utils.early_stopper.NoiseChunks`
    gives the same normals a chunk at a time, for runs too long to hold
    (CPU tensors only, every tier). Otherwise noise comes from
    ``generator``. ``shard``: the particles are columns j0 .. j0 + J_loc of a
    J-column run (``parallel/auto.py``): each tier draws those columns of
    the whole run's noise, and its energies are the shard's share of the
    run's (``utils/columns.py``), so it runs with infinite patience."""
    _require_known_basis(basis)
    if discretisation not in DISCRETISATIONS:
        raise ValueError(f"Unknown discretisation {discretisation!r}")
    if discretisation != "euler" and tier not in NON_EULER_TIERS[discretisation]:
        raise ValueError(
            f"discretisation={discretisation!r} is not implemented for the {tier!r} tier "
            f"(allowed: {NON_EULER_TIERS[discretisation]})"
        )
    dtype, device = particles.dtype, particles.device
    if isinstance(noise, NoiseChunks) and device.type != "cpu":
        raise ValueError(f"chunked injected noise is for CPU tensors, not {device}")
    generator = as_generator(generator, device=device)
    eta = float(step_size)
    root2eta = math.sqrt(2.0 * eta)

    if tier in ("spectral", "general_fused", "quadratic_fused"):
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
            energy_sigma = sigma
            # the IPB's update noise S z enters V as q_in^T S z = (S^T q_in)^T z
            q_noise = q_in if isinstance(basis, OrthonormalBasis) else basis.noise_factor.T @ q_in
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
            shard=shard,
        )
        return TrainResult(q_out @ w, energies, recorded, steps_run)
    if tier == "general_fused":
        kind, params, aux = general_fused_form(basis, cost)
        return TrainResult(*general_train(
            basis.train_projection,
            particles,
            cost.y_train,
            basis.eigenvalues,
            kind,
            eta=eta,
            patience=patience,
            num_steps=number_of_epochs,
            params=params,
            mean_shift=basis.mean_constant,
            aux=aux,
            discretisation=discretisation,
            seed=seed,
            noise=noise,
            generator=generator,
            shard=shard,
        ))
    if tier == "quadratic_fused":
        a_mat, b_vec, e_mat, e_bias, e_const, shared = _quadratic_system(basis, cost)
        return TrainResult(*quadratic_train(
            a_mat,
            b_vec,
            e_mat,
            e_bias,
            None if shared else basis.noise_factor,
            particles,
            eta=eta,
            patience=patience,
            e_const=e_const,
            num_steps=number_of_epochs,
            shared=shared,
            seed=seed,
            noise=noise,
            generator=generator,
            shard=shard,
        ))

    draw = _update_noise(basis, noise, generator, particles.shape[1], shard)
    if tier == "quadratic":
        a_mat, b_vec, e_mat, e_bias, e_const, shared = _quadratic_system(basis, cost)

        def step(t, state):
            # shared: v carries A u, one matmul per step serves this step's
            # drift and the previous update's energy
            u, v = state
            drift = (v if shared else a_mat @ u) - b_vec[:, None]
            u_new = u - eta * drift + root2eta * draw(t)
            v_new = (a_mat if shared else e_mat) @ u_new
            energy_j = 0.5 * torch.sum(u_new * v_new, dim=0) - e_bias @ u_new + e_const
            return (u_new, v_new), column_mean(energy_j, shard)

        state0 = (particles, a_mat @ particles if shared else torch.zeros_like(particles))
    elif tier == "off":
        if discretisation == "euler":

            def update(u, dc, t):
                return u + basis._calculate_particle_update(u, dc, eta, draw(t))

        else:
            update = _split_update(basis, eta, discretisation, draw)

        def step(t, state):
            # carries dc(F), F = P U: one call gives the cost of this step's
            # energy and the derivative of the next step's update
            u, dc = state
            u_new = update(u, dc, t)
            pred_new = basis.calculate_untransformed_train_prediction_samples(u_new)
            cost_j, dc_new = cost.calculate_cost_and_derivative(pred_new)
            energy_j = basis.calculate_particle_energies(u_new, cost_j)
            return (u_new, dc_new), column_mean(energy_j, shard)

        pred0 = basis.calculate_untransformed_train_prediction_samples(particles)
        state0 = (particles, cost.calculate_cost_and_derivative(pred0)[1])
    else:
        raise ValueError(f"Unknown tier {tier!r}")
    run = run_training(
        step, state0, number_of_epochs, eta, patience, dtype, device,
        generators=(generator,) if generator.device.type == "cuda" else (),
        what=f"the {tier} tier",
    )
    return TrainResult(run.state[0], run.energies, run.recorded, run.steps_run)


def _split_update(basis, eta: float, discretisation: str, draw):
    """The split schemes' update (ONB only): an explicit data sub-step, then
    the exact OU flow of the prior and its noise,
    U' = x - (1 - dec) x + nscale eps with x = U - eta ds P^T dc (the decay
    as its complement, as ``split_row_constants`` gives it)."""
    if not isinstance(basis, OrthonormalBasis):
        raise ValueError(
            f"discretisation={discretisation!r} requires the ONB basis "
            "(route IPB through training.ipb_w_space_view)"
        )
    lam = basis.eigenvalues.to(basis.train_projection.dtype)
    _, one_minus_dec, ds, nscale = (
        c[:, None] for c in split_row_constants(lam, eta, discretisation)
    )
    projection = basis.train_projection

    def update(u, dc, t):
        x = u - eta * (ds * (projection.T @ dc))
        # x - (1 - dec) x in one elementwise pass
        return torch.addcmul(x, one_minus_dec, x, value=-1.0) + nscale * draw(t)

    return update


def _train_pls_chunked(*args, **kwargs):
    """The JAX package's runner of very long runs in bounded device programs
    (its ``training.py:1030``), kept unported by name, a deliberate
    deviation: here every run of the ``off`` and ``quadratic`` tiers is
    already in chunks. On the card one step is captured into a CUDA graph
    and replayed, and the host reads the stop flag once every
    ``utils/early_stopper.CHECK_EVERY`` steps (``run_training``, the
    counterpart of that runner and of its ``_drain_chunks``); the whole-run
    kernels B1, B3 and B4 run a tier in one launch or in pieces of at most
    ``STEPS_PER_LAUNCH`` steps. Neither :func:`train_pls` nor
    ``parallel.parallel_train_pls`` calls it."""
    raise NotImplementedError(
        "_train_pls_chunked is not ported: train_pls and parallel_train_pls run every tier in "
        "chunks already (utils/early_stopper.run_training: CUDA-graph replays on the card, the "
        "stop flag read once a chunk), and the whole-run kernels launch in pieces themselves"
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
    takes the spectral tier for a Gaussian-identity cost, else off). An IPB
    model under a split scheme or ``general_fused`` trains in its W-space ONB
    view and leaves through U = S W (:func:`needs_w_space_reroute`). The
    spectral tier's factorisation runs in host fp64; on the card the
    ``off`` and ``quadratic`` tiers run as chunks of CUDA-graph replays of
    one step (``utils/early_stopper.run_training``). Under the profiler the
    call is the span ``pls.train_pls``, its read-back of the energies
    ``pls.train_pls.readback`` (``utils/tracing.span``)."""
    with span("pls.train_pls"):
        if generator is None and seed is not None:
            generator = seed
        if discretisation not in DISCRETISATIONS:
            raise ValueError(f"Unknown discretisation {discretisation!r}")
        basis, cost = pls.basis, pls.cost
        _require_known_basis(basis)
        exit_map = None
        if needs_w_space_reroute(basis, fast_path, discretisation):
            basis, s_mat, s_inv = ipb_w_space_view(basis)
            particles = s_inv @ particles
            exit_map = lambda u: s_mat @ u  # noqa: E731
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
        with span("pls.train_pls.readback"):
            energies = [
                float(e) for e, r in zip(result.energies.tolist(), result.recorded.tolist()) if r
            ]
        out = result.particles if exit_map is None else exit_map(result.particles)
        return out, energies


def langevin_steps(
    basis,
    cost,
    particles: torch.Tensor,
    generator: GeneratorLike = None,
    step_size: float = 1e-3,
    n_steps: int = 1,
    fast_path: str = "auto",
    spectral_system: SpectralSystem | None = None,
    discretisation: str = "euler",
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Throughput path: ``n_steps`` Langevin updates with no energy and no
    early stopping; returns the particles (``training.py:1224-1418`` of the
    JAX package).

    Tiers resolve with ``strict=False``: a combination no tier implements
    runs "off". The split schemes are ONB-native and an IPB model under one
    raises (pass its :func:`ipb_w_space_view`). spectral (B1),
    general_fused (B3) and quadratic_fused (B4) run their whole-run kernels
    with infinite patience; quadratic and the split schemes are loops; the
    Euler general body is one fused update (B5) per step for a cost with a
    closed form there (``closed_forms.dc_kind_for_cost``), else the basis's own update.
    ``noise`` (n_steps, M, J) injects the normals z as in
    :func:`_train_pls_loop`."""
    _require_known_basis(basis)
    generator = as_generator(generator, device=particles.device)
    eta, n_steps = float(step_size), int(n_steps)
    tier = resolve_tier(basis, cost, fast_path, discretisation, strict=False)
    if discretisation != "euler" and not isinstance(basis, OrthonormalBasis):
        tier = "off"  # raises below, naming ipb_w_space_view
    if tier in ("spectral", "general_fused", "quadratic_fused"):
        return _train_pls_loop(
            basis, cost, particles, eta, math.inf, n_steps, tier, spectral_system,
            generator=generator, noise=noise, discretisation=discretisation,
        ).particles
    draw = _update_noise(basis, noise, generator, particles.shape[1])
    root2eta = math.sqrt(2.0 * eta)
    u = particles
    if tier == "quadratic":
        a_mat, b_vec = _quadratic_system(basis, cost)[:2]
        for t in range(n_steps):
            u = u - eta * (a_mat @ u - b_vec[:, None]) + root2eta * draw(t)
        return u
    if discretisation != "euler":
        update = _split_update(basis, eta, discretisation, draw)
        for t in range(n_steps):
            pred = basis.calculate_untransformed_train_prediction_samples(u)
            u = update(u, cost.calculate_cost_derivative(pred), t)
        return u
    dc_spec = dc_kind_for_cost(cost)
    if dc_spec is None:  # no closed form in the fused update: the basis's own
        for t in range(n_steps):
            pred = basis.calculate_untransformed_train_prediction_samples(u)
            dc = cost.calculate_cost_derivative(pred)
            u = u + basis._calculate_particle_update(u, dc, eta, draw(t))
        return u
    kind, params = dc_spec
    if isinstance(basis, OrthonormalBasis):
        d, prior = basis.train_projection, 1.0 / basis.eigenvalues
    else:
        d = basis.base_gram_induce_train.T
        prior = basis.approximation_dimension * basis.inv_base_gram_induce
    for t in range(n_steps):
        u = fused_update(basis.train_projection, d, cost.y_train, u, prior, draw(t), kind,
                         eta=eta, params=params, mean_shift=basis.mean_constant)
    return u
