"""Shared pipeline pieces of the curve mains (counterpart of
``experiments/curves/common.py``): the kernel-learning -> inducing-point ->
PLS train-or-load sequence that every curve main repeats. No plots are
drawn; the predictions the JAX harness plots are still made
(:func:`experiments_torch.runners.predict_pls_1d_particles_runner`)."""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from experiments_torch.constructors import (
    construct_average_ard_kernel,
    construct_average_gaussian_likelihood_from_models,
    construct_average_mean_constant,
)
from experiments_torch.data import Data, ExperimentData
from experiments_torch.loaders import load_pls, save_pls
from experiments_torch.runners import (
    dirichlet_exact_gp_runner,
    exact_gp_runner,
    inducing_points_runner,
    predict_pls_1d_particles_runner,
    train_pls_runner,
)
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (  # noqa: E501
    ConditionalVarianceInducingPointSelector,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_torch.utils.device import as_tensor


def experiment_data_on(experiment_data: ExperimentData, device, dtype) -> ExperimentData:
    """A copy of ``experiment_data`` with every tensor on ``device`` (the card
    unless the caller asks for the CPU) in ``dtype``."""

    def move(data: Data | None) -> Data | None:
        if data is None:
            return None
        return dataclasses.replace(data, **{
            k: None if getattr(data, k) is None else as_tensor(getattr(data, k), device, dtype)
            for k in ("x", "y", "y_untransformed")})

    return dataclasses.replace(
        experiment_data, full=move(experiment_data.full), train=move(experiment_data.train),
        test=move(experiment_data.test), validation=move(experiment_data.validation))


def learn_kernel_and_inducing_points(
    experiment_data: ExperimentData,
    kernel_config: dict,
    inducing_points_config: dict,
    models_path: str,
    data_path: str,
    regression_targets=None,
    dirichlet_labels: bool = False,
):
    """Subsample exact-GP fits -> averaged ARD kernel (with the likelihood and
    mean constant) -> greedy inducing points with M = factor * N^(1/power).
    Returns (subsample GPs, ARD kernel, likelihood, mean constant, inducing
    points, PLS kernel).

    ``regression_targets``: fit the GPs on these targets instead of the
    train labels (surrogate regression labels). ``dirichlet_labels``:
    classification, the GPs fitted per class on Dirichlet-transformed
    logit-scale targets."""
    train = experiment_data.train
    if regression_targets is not None:
        experiment_data = dataclasses.replace(
            experiment_data, train=Data(x=train.x, y=regression_targets, name="train"))
    runner = dirichlet_exact_gp_runner if dirichlet_labels else exact_gp_runner
    subsample_gp_models = runner(
        experiment_data=experiment_data,
        kernel=ARDKernel(
            lengthscales=torch.ones(train.x.shape[1], dtype=train.x.dtype, device=train.x.device),
            outputscale=torch.tensor(1.0, dtype=train.x.dtype, device=train.x.device),
        ),
        subsample_size=kernel_config["subsample_size"],
        seed=kernel_config["seed"],
        number_of_epochs=kernel_config["number_of_epochs"],
        learning_rate=kernel_config["learning_rate"],
        number_of_iterations=kernel_config["number_of_iterations"],
        early_stopper_patience=kernel_config["early_stopper_patience"],
        model_path=os.path.join(models_path, "subsample_gp"),
        data_path=os.path.join(data_path, "subsample_gp"),
    )
    average_ard_kernel = construct_average_ard_kernel(
        kernels=[model.kernel for model in subsample_gp_models]
    )
    likelihood = construct_average_gaussian_likelihood_from_models(subsample_gp_models)
    mean_constant = construct_average_mean_constant(subsample_gp_models)
    inducing_points = inducing_points_runner(
        seed=inducing_points_config["seed"],
        inducing_point_selector=ConditionalVarianceInducingPointSelector(),
        data=train,
        number_induce_points=int(
            inducing_points_config["inducing_points_factor"]
            * math.pow(train.x.shape[0], 1 / inducing_points_config["inducing_points_power"])
        ),
        kernel=average_ard_kernel,
    )
    pls_kernel = PLSKernel(base_kernel=average_ard_kernel, approximation_samples=inducing_points.x)
    return (subsample_gp_models, average_ard_kernel, likelihood, mean_constant, inducing_points,
            pls_kernel)


def train_or_load_pls(
    pls,
    pls_name: str,
    experiment_data: ExperimentData,
    pls_config: dict,
    models_path: str,
    particles=None,
):
    """Initial predictions -> train or load -> learned predictions; returns
    (particles, best_lr, number_of_epochs). ``particles``: the initial
    particles (default: the basis's own initialisation)."""
    pls_path = os.path.join(models_path, f"{pls_name}.pkl")
    if particles is None:
        particles = pls.initialise_particles(
            number_of_particles=pls_config["number_of_particles"],
            noise_only=pls_config["initial_particles_noise_only"],
            seed=pls_config["seed"],
        )
    predict_pls_1d_particles_runner(pls=pls, particles=particles, experiment_data=experiment_data)
    if os.path.exists(pls_path):
        particles, _, best_lr, number_of_epochs = load_pls(pls_path, pls=pls)
    else:
        os.makedirs(models_path, exist_ok=True)
        particles, best_lr, number_of_epochs = train_pls_runner(
            pls=pls,
            particles=particles,
            particle_name=pls_name,
            experiment_data=experiment_data,
            simulation_duration=pls_config["simulation_duration"],
            step_size_upper=pls_config["step_size_upper"],
            number_of_step_searches=pls_config["number_of_step_searches"],
            maximum_number_of_steps=int(pls_config["maximum_number_of_steps"]),
            minimum_change_in_energy_potential=pls_config["minimum_change_in_energy_potential"],
            seed=pls_config["seed"],
            metric_to_optimise=pls_config["metric_to_optimise"],
            early_stopper_patience=pls_config["early_stopper_patience"],
            fast_path=pls_config.get("fast_path", "auto"),
            discretisation=pls_config.get("discretisation", "euler"),
            parallel=pls_config.get("parallel"),
        )
        save_pls(
            pls_path,
            particles=particles,
            observation_noise=pls.observation_noise,
            best_lr=best_lr,
            number_of_epochs=number_of_epochs,
            basis=pls.basis,
        )
    predict_pls_1d_particles_runner(pls=pls, particles=particles, experiment_data=experiment_data)
    return particles, best_lr, number_of_epochs


def refuse_gif(include_gif: bool) -> None:
    """The JAX mains' ``--include_gif true`` draws GIFs with matplotlib, a
    plotting library the port does not use."""
    if include_gif:
        raise NotImplementedError(
            "--include_gif needs matplotlib, the plotting library of the JAX harness's "
            "GIF runner (animate_pls_1d_particles_runner); the port draws no plots"
        )
