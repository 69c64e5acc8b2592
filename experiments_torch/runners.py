"""High-level orchestration (counterpart of ``experiments/runners.py``):
inducing-point selection, subsample-GP kernel learning, the log-spaced
step-size search for PLS and the log-spaced learning-rate search for SVGP.
The JAX harness's plotting runners draw nothing here:
:func:`predict_pls_1d_particles_runner` makes the predictions its 1-D
particle plot draws and returns them, and its GIF runner is not ported.

``subsample_data_indices`` rebuilds the JAX harness's scikit-learn
``NearestNeighbors`` query in numpy: the ``subsample_size`` rows nearest a
random row, nearest first. Rows at exactly equal distance (duplicate rows)
come in row order here; scikit-learn's order for them depends on the
algorithm it picks.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from experiments_torch.data import Data, ExperimentData
from experiments_torch.loaders import (
    load_ard_exact_gp_model,
    load_svgp,
    save_ard_exact_gp_model,
    save_svgp,
)
from experiments_torch.metrics import (
    calculate_acc,
    calculate_auc,
    calculate_f1,
    calculate_mae,
    calculate_mse,
    calculate_nll,
)
from experiments_torch.trainers import train_exact_gp, train_pls, train_svgp
from experiments_torch.utils import create_directory
from projected_langevin_sampling_torch.models.conformalise.pls import ConformalisePLS
from projected_langevin_sampling_torch.models.gaussian_process.dirichlet import (
    dirichlet_classification_targets,
)
from projected_langevin_sampling_torch.models.inducing_point_selectors.base import (
    InducingPointSelector,
)
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.models.temper.pls import TemperPLS
from projected_langevin_sampling_torch.ops.kernels import ARDKernel
from projected_langevin_sampling_torch.training import resolve_tier


def dirichlet_exact_gp_runner(
    experiment_data: ExperimentData,
    kernel: ARDKernel,
    subsample_size: int,
    seed: int,
    number_of_epochs: int,
    learning_rate: float,
    number_of_iterations: int,
    early_stopper_patience: float,
    model_path: str,
    data_path: str,
) -> list:
    """Classification kernel learning: Dirichlet-transform the labels, fit
    the subsample GPs per class on the logit-scale targets with the
    per-point fixed noise, and return all models (classes x iterations) for
    kernel averaging. Fitting on raw 0/1 labels instead learns an
    outputscale about 100x too small."""
    targets, noise_variances, num_classes = dirichlet_classification_targets(
        experiment_data.train.y
    )
    models = []
    for c in range(num_classes):
        experiment_data_c = ExperimentData(
            name=experiment_data.name,
            problem_type=experiment_data.problem_type,
            full=experiment_data.full,
            train=Data(x=experiment_data.train.x, y=targets[c], name="train"),
            test=experiment_data.test,
            validation=experiment_data.validation,
        )
        models.extend(
            exact_gp_runner(
                experiment_data=experiment_data_c,
                kernel=kernel,
                subsample_size=subsample_size,
                seed=seed,
                number_of_epochs=number_of_epochs,
                learning_rate=learning_rate,
                number_of_iterations=number_of_iterations,
                early_stopper_patience=early_stopper_patience,
                model_path=os.path.join(model_path, f"class_{c}"),
                data_path=os.path.join(data_path, f"class_{c}"),
                fixed_noise_variances=noise_variances[c],
            )
        )
    return models


def inducing_points_runner(
    seed: int,
    inducing_point_selector: InducingPointSelector,
    data: Data,
    number_induce_points: int,
    kernel: ARDKernel,
) -> Data:
    """Select inducing points and their labels; the selector's host
    generator is ``numpy.random.default_rng(seed)``."""
    x = data.x.reshape(data.x.shape[0], -1)
    x_induce, induce_indices = inducing_point_selector(
        x=x,
        m=number_induce_points,
        kernel=kernel,
        rng=np.random.default_rng(seed),
    )
    idx = induce_indices.to(data.x.device)
    return Data(
        x=x_induce,
        y=None if data.y is None else data.y[idx],
        y_untransformed=None if data.y_untransformed is None else data.y_untransformed[idx],
        name="induce",
    )


def subsample_data_indices(x, subsample_size: int, seed: int | None = None):
    """Indices of the ``subsample_size`` rows nearest a random row (drawn by
    ``numpy.random.default_rng(seed)``), nearest first; None when the
    subsample would hold every row."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if subsample_size > len(x):
        return None
    rng = np.random.default_rng(seed)
    x = x.reshape(x.shape[0], -1)
    centre = x[rng.integers(x.shape[0])]
    squared = np.zeros(x.shape[0])
    for d in range(x.shape[1]):  # dimension by dimension, as a tree query sums them
        squared += np.square(x[:, d] - centre[d])
    return np.argsort(squared, kind="stable")[:subsample_size]


def load_subsample_data(data: Data, subsample_size: int, seed: int | None = None) -> Data:
    """The kNN neighbourhood subsample of ``data`` around a random row."""
    idx = subsample_data_indices(data.x, subsample_size, seed)
    if idx is None:
        return data
    idx = torch.as_tensor(idx, device=data.x.device)
    return Data(x=data.x[idx], y=data.y[idx])


def exact_gp_runner(
    experiment_data: ExperimentData,
    kernel: ARDKernel,
    subsample_size: int,
    seed: int,
    number_of_epochs: int,
    learning_rate: float,
    number_of_iterations: int,
    early_stopper_patience: float,
    model_path: str,
    data_path: str,
    fixed_noise_variances=None,
) -> list:
    """Train or load k subsample exact GPs, iteration i on the kNN subsample
    of seed ``seed + i``. ``fixed_noise_variances``: per-train-point noise
    (N,), subsampled with the same indices (the Dirichlet case)."""
    create_directory(model_path)
    create_directory(data_path)
    device = experiment_data.train.x.device
    models = []
    if subsample_size >= len(experiment_data.train.x):
        number_of_iterations = 1
        model_name = "full_exact_gp"
    else:
        model_name = "subsample_exact_gp"
    for i in range(number_of_iterations):
        ckpt = os.path.join(model_path, f"{model_name}_{i + 1}_of_{number_of_iterations}.pkl")
        if os.path.exists(ckpt):
            model, _ = load_ard_exact_gp_model(ckpt, device=device)
        else:
            idx = subsample_data_indices(experiment_data.train.x, subsample_size, seed=seed + i)
            if idx is None:
                data = experiment_data.train
                fixed_i = fixed_noise_variances
            else:
                idx = torch.as_tensor(idx, device=device)
                data = Data(x=experiment_data.train.x[idx], y=experiment_data.train.y[idx])
                fixed_i = None if fixed_noise_variances is None else fixed_noise_variances[idx]
            model, losses = train_exact_gp(
                data=data,
                kernel=kernel,
                seed=seed + i,
                number_of_epochs=number_of_epochs,
                learning_rate=learning_rate,
                early_stopper_patience=early_stopper_patience,
                fixed_noise_variances=fixed_i,
            )
            save_ard_exact_gp_model(ckpt, model, losses)
        models.append(model)
    return models


def _search_metric(pls: PLS, particles, experiment_data, metric: str, energies) -> float:
    if metric == "loss":
        return energies[-1]
    prediction = pls.predict(x=experiment_data.train.x, particles=particles, generator=0)
    y_train = experiment_data.train.y
    if metric in ("acc", "auc", "f1"):
        return {"acc": calculate_acc, "auc": calculate_auc,
                "f1": calculate_f1}[metric](prediction.probs, y_train)
    return {"nll": calculate_nll, "mse": calculate_mse,
            "mae": calculate_mae}[metric](prediction=prediction, y=y_train)


def train_pls_runner(
    pls: PLS,
    particle_name: str,
    experiment_data: ExperimentData,
    simulation_duration: float,
    maximum_number_of_steps: int,
    early_stopper_patience: float,
    number_of_step_searches: int,
    step_size_upper: float,
    minimum_change_in_energy_potential: float,
    seed: int,
    particles: torch.Tensor,
    metric_to_optimise: str = "nll",
    fast_path: str = "auto",
    discretisation: str = "euler",
    parallel: dict | None = None,
    equilibrate_spread: float | None = None,
) -> tuple[torch.Tensor, float | None, int]:
    """Log-spaced step-size search: each candidate runs for
    simulation_duration / step_size epochs from the same initial particles;
    the best by the train-split metric wins; the search breaks once the
    final energy moves by less than ``minimum_change_in_energy_potential``
    (relative) between consecutive candidates. A candidate whose best or
    final energy is above the initial particles' has diverged and is
    skipped, as is one with non-finite particles.

    Each candidate's line gives its time on the host clock (the energies are
    read back, which waits for the device) per step, and the tier
    ``train_pls`` resolves for the model.

    ``equilibrate_spread`` (default off): with a float threshold, the
    winning chain continues in chunks of its own length at its step size
    until the mean per-coordinate particle variance changes by less than
    that relative factor between chunks (at most
    ``maximum_number_of_steps`` epochs in all, 16 chunks)."""
    if metric_to_optimise in ["nll", "mse", "mae", "loss"]:
        best_metric_value = float("inf")
    elif metric_to_optimise in ["acc", "auc", "f1"]:
        best_metric_value = 0.0
    else:
        raise NotImplementedError(f"Unknown metric to optimise {metric_to_optimise}.")
    best_lr = None
    energy_potentials_history: dict[float, list[float]] = {}
    step_sizes = np.logspace(
        np.log10(step_size_upper),
        np.log10(simulation_duration / maximum_number_of_steps),
        number_of_step_searches,
    )
    tier = resolve_tier(pls.basis, pls.cost, fast_path, discretisation)
    particles_out = particles
    initial_energy = float(pls.calculate_energy_potential(particles))
    for i, step_size in enumerate(step_sizes):
        number_of_epochs = int(simulation_duration / step_size)
        start = time.perf_counter()
        particles_i, energy_potentials = train_pls(
            pls=pls,
            particles=particles,
            number_of_epochs=number_of_epochs,
            step_size=float(step_size),
            early_stopper_patience=early_stopper_patience,
            seed=seed,
            fast_path=fast_path,
            discretisation=discretisation,
            parallel=parallel,
        )
        seconds = time.perf_counter() - start
        diverged = bool(energy_potentials) and not (
            min(energy_potentials) <= initial_energy
            and energy_potentials[-1] <= initial_energy
        )
        finite = bool(torch.isfinite(particles_i).all())
        nan = float("nan")
        print(
            f"  [search {particle_name}] eta={float(step_size):.3e} "
            f"epochs={number_of_epochs} recorded={len(energy_potentials)} "
            f"E0={initial_energy:.4g} "
            f"min={min(energy_potentials) if energy_potentials else nan:.4g} "
            f"last={energy_potentials[-1] if energy_potentials else nan:.4g} "
            f"diverged={diverged} finite={finite} tier={tier} "
            f"ms/step={1e3 * seconds / max(number_of_epochs, 1):.5f}",
            flush=True,
        )
        if energy_potentials and not diverged and finite:
            energy_potentials_history[float(step_size)] = energy_potentials
            metric_value = _search_metric(pls, particles_i, experiment_data, metric_to_optimise,
                                          energy_potentials)
            if (
                metric_to_optimise in ["nll", "mse", "mae", "loss"]
                and metric_value < best_metric_value
            ) or (
                metric_to_optimise in ["acc", "auc", "f1"]
                and metric_value > best_metric_value
            ):
                best_metric_value = metric_value
                best_lr = float(step_size)
                particles_out = particles_i
            prev = float(step_sizes[i - 1]) if i > 0 else None
            # relative to |previous final energy| with a floor: energies may
            # be negative or exactly 0
            if (
                prev is not None
                and prev in energy_potentials_history
                and abs(energy_potentials_history[prev][-1] - energy_potentials[-1])
                / max(abs(energy_potentials_history[prev][-1]), 1e-30)
                < minimum_change_in_energy_potential
            ):
                break
    best_epochs = len(energy_potentials_history[best_lr]) if best_lr is not None else 0
    if equilibrate_spread is not None and best_lr is not None and best_epochs > 0:
        particles_out, best_epochs = _equilibrate_spread_phase(
            pls=pls,
            particles=particles_out,
            step_size=best_lr,
            chunk_epochs=best_epochs,
            threshold=float(equilibrate_spread),
            max_total_epochs=int(maximum_number_of_steps),
            early_stopper_patience=early_stopper_patience,
            seed=seed,
            fast_path=fast_path,
            discretisation=discretisation,
            parallel=parallel,
            particle_name=particle_name,
        )
    return particles_out, best_lr, best_epochs


def _equilibrate_spread_phase(
    pls,
    particles: torch.Tensor,
    step_size: float,
    chunk_epochs: int,
    threshold: float,
    max_total_epochs: int,
    early_stopper_patience: float,
    seed: int,
    fast_path: str,
    discretisation: str,
    parallel: dict | None,
    particle_name: str,
    max_chunks: int = 16,
) -> tuple[torch.Tensor, int]:
    """Continue the winning chain until the particle spread plateaus (see
    ``train_pls_runner``'s ``equilibrate_spread``). A chunk with non-finite
    particles or an energy above its starting energy is discarded and
    stops the phase."""

    def spread(p: torch.Tensor) -> float:
        # numpy's population variance over the particles (ddof 0)
        return float(torch.mean(torch.var(p, dim=1, unbiased=False)))

    total = chunk_epochs
    s_prev = spread(particles)
    e_prev = float(pls.calculate_energy_potential(particles))
    for chunk in range(max_chunks):
        if total + chunk_epochs > max_total_epochs:
            break
        p_new, energies = train_pls(
            pls=pls,
            particles=particles,
            number_of_epochs=chunk_epochs,
            step_size=float(step_size),
            early_stopper_patience=early_stopper_patience,
            seed=seed + 7919 * (chunk + 1),  # deterministic, distinct per chunk
            fast_path=fast_path,
            discretisation=discretisation,
            parallel=parallel,
        )
        if not (
            energies
            and bool(torch.isfinite(p_new).all())
            and energies[-1] <= e_prev + 1e-3 * abs(e_prev) + 1e-9
        ):
            print(
                f"  [equilibrate {particle_name}] chunk {chunk}: discarded "
                f"(non-finite or energy rose) — stopping",
                flush=True,
            )
            break
        s_new = spread(p_new)
        rel = abs(s_new - s_prev) / max(abs(s_prev), 1e-30)
        total += len(energies)
        particles, s_prev, e_prev = p_new, s_new, energies[-1]
        print(
            f"  [equilibrate {particle_name}] chunk {chunk}: +{len(energies)} "
            f"epochs (total {total}), spread={s_new:.5g} (rel change {rel:.3g}), "
            f"E={e_prev:.6g}",
            flush=True,
        )
        if rel < threshold:
            break
    return particles, total


def train_svgp_runner(
    model_name: str,
    experiment_data: ExperimentData,
    inducing_points: Data,
    kernel,
    likelihood,
    seed: int,
    number_of_epochs: int,
    batch_size: int,
    learning_rate_upper: float,
    learning_rate_lower: float,
    number_of_learning_rate_searches: int,
    is_fixed: bool,
    models_path: str,
    early_stopper_patience: float,
    observation_noise: float | None = None,
    mean_constant: float = 0.0,
    load_model: bool = True,
):
    """Log-spaced learning-rate search for SVGP, lowest final loss wins.
    Returns (model, losses, best_learning_rate)."""
    create_directory(models_path)
    device = experiment_data.train.x.device
    best_loss = float("inf")
    model_out, losses_out, best_learning_rate = None, None, None
    for i, learning_rate in enumerate(
        np.logspace(
            math.log10(learning_rate_lower),
            math.log10(learning_rate_upper),
            number_of_learning_rate_searches,
        )
    ):
        ckpt = os.path.join(models_path, f"svgp_{i + 1}_of_{number_of_learning_rate_searches}.pkl")
        if os.path.exists(ckpt) and load_model:
            model, losses, _ = load_svgp(ckpt, likelihood, device=device)
        else:
            model, losses = train_svgp(
                train_data=experiment_data.train,
                inducing_points=inducing_points,
                kernel=kernel,
                likelihood=likelihood,
                seed=seed,
                number_of_epochs=number_of_epochs,
                batch_size=batch_size,
                learning_rate=float(learning_rate),
                learn_inducing_locations=not is_fixed,
                learn_kernel_parameters=not is_fixed,
                early_stopper_patience=early_stopper_patience,
                likelihood_noise=observation_noise,
                mean_constant=mean_constant,
            )
            if model is None:
                print(
                    f"  [search {model_name}] lr={learning_rate:.3e} "
                    "diverged (non-finite parameters)",
                    flush=True,
                )
                continue
            # the checkpoint records the candidate's own rate
            save_svgp(ckpt, model, losses, float(learning_rate))
        if not losses:
            continue
        print(
            f"  [search {model_name}] lr={learning_rate:.3e} "
            f"epochs={len(losses)} loss0={losses[0]:.4g} lossN={losses[-1]:.4g}",
            flush=True,
        )
        loss = losses[-1]
        if loss < best_loss:
            best_loss = loss
            best_learning_rate = float(learning_rate)
            model_out = model
            losses_out = losses
    return model_out, losses_out, best_learning_rate


def predict_pls_1d_particles_runner(pls, particles: torch.Tensor,
                                    experiment_data: ExperimentData):
    """The predictions of the JAX harness's ``plot_pls_1d_particles_runner``
    on the full grid, which it plots and this returns:
    ``(predicted distribution, predicted samples, untransformed samples)``.
    The distribution is ``PLS.predict`` with generator 0, or the conformal
    model's ``predict`` at coverage 0.95 or the tempered model's; for a
    plain PLS the samples are ``predict_samples`` with generator 1 and,
    where the data carry ``y_untransformed``,
    ``predict_untransformed_samples`` with generator 2 (else None)."""
    x_full = experiment_data.full.x
    if isinstance(pls, PLS):
        predicted_distribution = pls.predict(x=x_full, particles=particles, generator=0)
    elif isinstance(pls, ConformalisePLS):
        predicted_distribution = pls.predict(x=x_full, coverage=0.95)
    elif isinstance(pls, TemperPLS):
        predicted_distribution = pls.predict(x=x_full)
    else:
        raise TypeError(f"Unknown PLS type: {type(pls)}")
    predicted_samples = untransformed = None
    if isinstance(pls, PLS):
        predicted_samples = pls.predict_samples(x=x_full, particles=particles, generator=1)
        if experiment_data.full.y_untransformed is not None:
            untransformed = pls.predict_untransformed_samples(x=x_full, particles=particles,
                                                              generator=2)
    return predicted_distribution, predicted_samples, untransformed
