"""UCI binary-classification experiments (counterpart of
``experiments/uci/classification/main.py``): PLS-ONB with the Bernoulli
(sigmoid) cost, optionally residual-smoothed, beside an SVGP (probit)
baseline; acc, auc, f1 and nll CSVs joined across datasets.

Runs on the card (``--device cuda``) in fp64 (``--dtype float64``) unless
asked otherwise; it never moves to the CPU on its own, and draws no plot.

    python -m experiments_torch.uci.classification.main \\
        --config_path experiments/uci/classification/config_precond_smooth.yaml \\
        --dataset rice --data_seed 0
"""

from __future__ import annotations

import argparse
import math
import os
import traceback

import numpy as np
import torch

from experiments_torch.config import load_config
from experiments_torch.constructors import (
    construct_average_ard_kernel,
    construct_average_mean_constant,
)
from experiments_torch.data import ExperimentData, ProblemType, read_dataset
from experiments_torch.loaders import (
    load_inducing_points,
    load_pls,
    load_svgp,
    save_inducing_points,
    save_pls,
    save_svgp,
)
from experiments_torch.metrics import calculate_metrics, calculate_nll, concatenate_seed
from experiments_torch.preprocess import set_up_experiment
from experiments_torch.runners import (
    dirichlet_exact_gp_runner,
    inducing_points_runner,
    train_pls_runner,
    train_svgp_runner,
)
from experiments_torch.uci.constants import (
    EXTRA_CLASSIFICATION_DATASETS,
    ClassificationDatasetSchema,
    resolve_schema,
)
from experiments_torch.utils import Stages
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    make_smoothed_bernoulli_cost,
    residual_smoothing_std,
)
from projected_langevin_sampling_torch.models.gaussian_process import BernoulliLikelihood
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (  # noqa: E501
    ConditionalVarianceInducingPointSelector,
)
from projected_langevin_sampling_torch.models.link_functions import SigmoidLinkFunction
from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel

MODEL_NAMES = ["pls-onb", "svgp"]
METRICS = ["acc", "auc", "f1", "nll"]
DATASETS_DIR = os.path.join("experiments", "uci", "datasets")


def binary_labels(y_text: np.ndarray, dataset_name: str) -> np.ndarray:
    """0/1 labels: text labels are numbered in sorted order first; then the
    larger of the two observed values is 1 (a sign test would put the
    common {1, 2} coding in one class). Anything but two values raises."""
    try:
        y_num = y_text.astype(float)
    except ValueError:
        labels = sorted(set(y_text.tolist()))
        y_num = np.array([labels.index(v) for v in y_text.tolist()], dtype=float)
    values = np.unique(y_num)
    if values.shape[0] != 2:
        raise ValueError(
            f"{dataset_name}: expected binary labels, got {values.shape[0]} "
            f"distinct values {values[:5]}"
        )
    return (y_num == values.max()).astype(float)


def get_experiment_data(
    seed: int,
    train_data_percentage: float,
    validation_data_percentage: float,
    dataset_name: str,
    datasets_dir: str = DATASETS_DIR,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ExperimentData:
    x, y = read_dataset(os.path.join(datasets_dir, f"{dataset_name}.csv"),
                        resolve_schema(dataset_name))
    return set_up_experiment(
        name=dataset_name,
        problem_type=ProblemType.CLASSIFICATION,
        seed=seed,
        x=x,
        y=binary_labels(y, dataset_name),
        train_data_percentage=train_data_percentage,
        validation_data_percentage=validation_data_percentage,
        normalise=False,
        device=device,
        dtype=dtype,
    )


def main(
    data_seed: int,
    dataset_name: str,
    data_config: dict,
    kernel_config: dict,
    inducing_points_config: dict,
    pls_config: dict,
    svgp_config: dict,
    metrics_config: dict,
    outputs_path: str,
    datasets_dir: str = DATASETS_DIR,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> None:
    print(f"Running experiment for {dataset_name=} and {data_seed=}.")
    stages = Stages(device)
    data_path = os.path.join(outputs_path, str(data_seed), "data", dataset_name)
    results_path = os.path.join(outputs_path, str(data_seed), "results", dataset_name)
    models_path = os.path.join(outputs_path, str(data_seed), "models", dataset_name)
    for p in (data_path, results_path, models_path):
        os.makedirs(p, exist_ok=True)

    experiment_data_path = os.path.join(data_path, "experiment_data.pkl")
    inducing_points_path = os.path.join(data_path, "inducing_points.pkl")
    if os.path.exists(experiment_data_path):
        experiment_data = ExperimentData.load(
            path=experiment_data_path, problem_type=ProblemType.CLASSIFICATION, device=device,
            dtype=dtype,
        )
    else:
        experiment_data = get_experiment_data(
            seed=data_seed,
            train_data_percentage=data_config["train_data_percentage"],
            validation_data_percentage=data_config["validation_data_percentage"],
            dataset_name=dataset_name,
            datasets_dir=datasets_dir,
            device=device,
            dtype=dtype,
        )
        experiment_data.save(experiment_data_path)
    stages.done("data")

    # kernel hyperparameters from subsample GPs on the Dirichlet-transformed
    # labels: logit-scale targets per class with fixed per-point noise
    d = experiment_data.train.x.shape[1]
    subsample_gp_models = dirichlet_exact_gp_runner(
        experiment_data=experiment_data,
        kernel=ARDKernel(
            lengthscales=torch.ones(d, dtype=dtype, device=device),
            outputscale=torch.tensor(1.0, dtype=dtype, device=device),
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
    mean_constant = construct_average_mean_constant(subsample_gp_models)
    stages.done("Dirichlet exact GPs")

    if os.path.exists(inducing_points_path):
        inducing_points = load_inducing_points(inducing_points_path, device)
    else:
        inducing_points = inducing_points_runner(
            seed=inducing_points_config["seed"],
            inducing_point_selector=ConditionalVarianceInducingPointSelector(),
            data=experiment_data.train,
            number_induce_points=int(
                inducing_points_config["inducing_points_factor"]
                * math.pow(
                    experiment_data.train.x.shape[0],
                    1 / inducing_points_config["inducing_points_power"],
                )
            ),
            kernel=average_ard_kernel,
        )
        save_inducing_points(inducing_points_path, inducing_points)
    stages.done("inducing points")

    pls_kernel = PLSKernel(base_kernel=average_ard_kernel, approximation_samples=inducing_points.x)
    # the prior mean constant (opt-in; the reference's is zero):
    #   "gp"     the learned GP constant SVGP gets;
    #   "select" train under both 0 and the GP constant, keep the better
    #            train-split NLL;
    #   "map"    the empirical-Bayes constant maximising the penalised
    #            posterior jointly over [m0; U]
    m0_mode = pls_config.get("mean_constant")
    if m0_mode == "gp":
        m0_candidates = [float(mean_constant)]
    elif m0_mode == "select":
        m0_candidates = [0.0, float(mean_constant)]
    else:
        m0_candidates = [0.0]
    onb_basis = build_orthonormal_basis(
        kernel=pls_kernel,
        x_induce=inducing_points.x,
        x_train=experiment_data.train.x,
        scaling=pls_config.get("onb_scaling", "reference"),
        relative_eigenvalue_threshold=pls_config.get("onb_relative_eigenvalue_threshold"),
        mean_constant=m0_candidates[0],
    )
    cost = BernoulliCost(y_train=experiment_data.train.y, link_function=SigmoidLinkFunction())
    # residual smoothing (opt-in; needs onb_scaling "nystrom"): train against
    # E_{eps ~ N(0, k_ii - Q_ii)}[log p(y_i | f_i + eps)], the data term of
    # SVGP's ELBO
    if pls_config.get("cost_smoothing") == "residual":
        smoothing_std = residual_smoothing_std(
            onb_basis, average_ard_kernel(experiment_data.train.x, diag=True)
        )
        cost = make_smoothed_bernoulli_cost(
            y_train=experiment_data.train.y, smoothing_std=smoothing_std
        )
    pls_name = "pls-onb"
    pls_path = os.path.join(models_path, f"{pls_name}.pkl")
    if m0_mode == "map" and not os.path.exists(pls_path):
        # only when training: a checkpoint restores its own constant
        m0_map = fit_mean_constant_map(basis=onb_basis, cost=cost)
        print(f"  [mean-constant map] m0={m0_map:.4f}", flush=True)
        m0_candidates = [m0_map]
        onb_basis = onb_basis.replace(mean_constant=m0_map)
    pls = PLS(basis=onb_basis, cost=cost, name=pls_name)
    stages.done("ONB build, cost, mean constant")
    particles = pls.initialise_particles(
        number_of_particles=pls_config["number_of_particles"],
        noise_only=pls_config["initial_particles_noise_only"],
        seed=pls_config["seed"],
    )
    if os.path.exists(pls_path):
        particles, _, _, _ = load_pls(pls_path, pls=pls)
    else:
        best = None  # (train_nll, m0, particles, best_lr, number_of_epochs)
        init_particles = particles
        for m0 in m0_candidates:
            pls.basis = onb_basis.replace(mean_constant=m0)
            particles_c, best_lr, number_of_epochs = train_pls_runner(
                pls=pls,
                particles=init_particles,
                particle_name=pls.name,
                experiment_data=experiment_data,
                simulation_duration=pls_config["simulation_duration"],
                maximum_number_of_steps=int(pls_config["maximum_number_of_steps"]),
                step_size_upper=pls_config["step_size_upper"],
                number_of_step_searches=pls_config["number_of_step_searches"],
                minimum_change_in_energy_potential=pls_config[
                    "minimum_change_in_energy_potential"
                ],
                seed=pls_config["seed"],
                metric_to_optimise=pls_config["metric_to_optimise"],
                early_stopper_patience=pls_config["early_stopper_patience"],
                fast_path=pls_config.get("fast_path", "auto"),
                discretisation=pls_config.get("discretisation", "euler"),
                parallel=pls_config.get("parallel"),
                equilibrate_spread=pls_config.get("equilibrate_spread"),
            )
            if len(m0_candidates) == 1:
                best = (float("nan"), m0, particles_c, best_lr, number_of_epochs)
                break
            prediction = pls.predict(x=experiment_data.train.x, particles=particles_c,
                                     generator=0)
            train_nll = calculate_nll(prediction=prediction, y=experiment_data.train.y)
            print(f"  [mean-constant select] m0={m0:.4f} train_nll={train_nll:.4f}", flush=True)
            if best is None or train_nll < best[0]:
                best = (train_nll, m0, particles_c, best_lr, number_of_epochs)
        _, best_m0, particles, best_lr, number_of_epochs = best
        pls.basis = onb_basis.replace(mean_constant=best_m0)
        save_pls(
            pls_path,
            particles=particles,
            observation_noise=pls.observation_noise,
            best_lr=best_lr,
            number_of_epochs=number_of_epochs,
            mean_constant=best_m0,
            basis=pls.basis,
        )
    stages.done(f"{pls_name} step-size search")
    calculate_metrics(
        model=pls,
        particles=particles,
        model_name=pls.name,
        dataset_name=dataset_name,
        experiment_data=experiment_data,
        results_path=results_path,
        coverage=metrics_config["coverage"],
    )
    stages.done(f"{pls_name} metrics")

    svgp_path = os.path.join(models_path, "svgp.pkl")
    if os.path.exists(svgp_path):
        svgp, _, _ = load_svgp(svgp_path, likelihood=BernoulliLikelihood(), device=device)
    else:
        svgp, losses, best_learning_rate = train_svgp_runner(
            model_name="svgp",
            experiment_data=experiment_data,
            inducing_points=inducing_points,
            kernel=pls_kernel,
            likelihood=BernoulliLikelihood(),
            seed=svgp_config["seed"],
            number_of_epochs=svgp_config["number_of_epochs"],
            batch_size=svgp_config["batch_size"],
            learning_rate_upper=svgp_config["learning_rate_upper"],
            learning_rate_lower=svgp_config["learning_rate_lower"],
            number_of_learning_rate_searches=svgp_config["number_of_learning_rate_searches"],
            is_fixed=True,
            mean_constant=float(mean_constant),
            early_stopper_patience=svgp_config["early_stopper_patience"],
            models_path=os.path.join(models_path, "svgp-kernel-iterations"),
        )
        if svgp is not None:
            save_svgp(svgp_path, svgp, losses, best_learning_rate)
    stages.done("svgp learning-rate search")
    if svgp is not None:
        calculate_metrics(
            model=svgp,
            model_name="svgp",
            dataset_name=dataset_name,
            experiment_data=experiment_data,
            results_path=results_path,
            coverage=metrics_config["coverage"],
        )
        stages.done("svgp metrics")


def dataset_names_of(dataset: str | None) -> list[str]:
    """``--dataset`` also takes the extra offline real datasets; the whole
    sweep is the reference's eight."""
    if dataset and dataset in EXTRA_CLASSIFICATION_DATASETS:
        return [dataset]
    if dataset:
        return [ClassificationDatasetSchema(dataset).value]
    return [d.value for d in ClassificationDatasetSchema]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Main script for UCI classification experiments.")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--data_seed", type=int, required=False, default=-1)
    p.add_argument("--dataset", type=str, required=False, default=None)
    p.add_argument("--outputs_dirname", type=str, required=False, default="outputs",
                   help="outputs subdirectory (use a distinct one for non-default configs)")
    p.add_argument("--datasets_dir", type=str, default=DATASETS_DIR,
                   help="directory of the <dataset>.csv files")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float64", choices=("float64", "float32"))
    return p


def cli(argv: list[str] | None = None) -> None:
    """The sweep over data seeds and datasets. A dataset that fails prints
    its traceback and the sweep goes on; each seed's tables are joined at
    its end."""
    args = parser().parse_args(argv)
    config = load_config(args.config_path)
    outputs_path = os.path.join(os.path.dirname(os.path.realpath(__file__)), args.outputs_dirname)
    data_seeds = [args.data_seed] if args.data_seed >= 0 else list(range(10))
    dataset_names = dataset_names_of(args.dataset)
    for seed in data_seeds:
        for dataset_name in dataset_names:
            try:
                main(
                    data_seed=seed,
                    dataset_name=dataset_name,
                    data_config=config["data"],
                    kernel_config=config["kernel"],
                    inducing_points_config=config["inducing_points"],
                    pls_config=config["pls"],
                    svgp_config=config["svgp"],
                    metrics_config=config["metrics"],
                    outputs_path=outputs_path,
                    datasets_dir=args.datasets_dir,
                    device=args.device,
                    dtype=getattr(torch, args.dtype),
                )
            except Exception as e:
                # the full traceback: a swallowed config typo otherwise turns a
                # long sweep into an exit-0 run with empty outputs
                print(f"Dataset {dataset_name} failed: {e}")
                print(traceback.format_exc())
        concatenate_seed(outputs_path, seed, dataset_names, MODEL_NAMES, METRICS)


if __name__ == "__main__":
    cli()
