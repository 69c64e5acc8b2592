"""UCI regression experiments (counterpart of ``experiments/uci/regression/main.py``):
datasets x 12 model variants, {PLS-ONB, PLS-Student-ONB, SVGP, SVGP-Student}
x {raw, temper, conformalise}, over data seeds, with metric CSVs joined by
``concatenate_metrics``. The Student-T degrees of freedom and scale are
fitted to the subsample-GP residuals with scipy.

Runs on the card (``--device cuda``) in fp64 (``--dtype float64``, the JAX
main's default) unless asked otherwise; it never moves to the CPU on its
own. It writes every results CSV and checkpoint the JAX main writes, and no
plot. A config with ``pls.parallel`` (``config_parallel.yaml``) runs one
process a rank (see :func:`main`):

    torchrun --nproc-per-node 4 -m experiments_torch.uci.regression.main \\
        --config_path experiments_torch/uci/regression/config_parallel_2x2_short.yaml \\
        --dataset energy_cooling --data_seed 0
    python -m experiments_torch.uci.regression.launch_cpu_ranks --ranks 8 -- \\
        --config_path experiments/uci/regression/config_parallel.yaml ...

    python -m experiments_torch.uci.regression.main \\
        --config_path experiments/uci/regression/config_precond_map.yaml \\
        --dataset kin8nm --data_seed 0
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile
import traceback

import scipy.stats
import torch
import torch.distributed as dist

from experiments_torch.config import load_config
from experiments_torch.constructors import (
    construct_average_ard_kernel,
    construct_average_gaussian_likelihood_from_models,
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
from experiments_torch.metrics import calculate_metrics, concatenate_seed
from experiments_torch.preprocess import set_up_experiment
from experiments_torch.runners import (
    exact_gp_runner,
    inducing_points_runner,
    train_pls_runner,
    train_svgp_runner,
)
from experiments_torch.utils import Stages
from experiments_torch.uci.constants import (
    EXTRA_REGRESSION_DATASETS,
    RegressionDatasetSchema,
    resolve_schema,
)
from projected_langevin_sampling_torch.models.basis.noise_distributions import (
    StudentTPredictiveNoise,
)
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.conformalise import (
    ConformaliseGP,
    ConformalisePLS,
)
from projected_langevin_sampling_torch.models.costs import GaussianCost, StudentTCost
from projected_langevin_sampling_torch.models.gaussian_process import (
    GaussianLikelihood,
    StudentTLikelihood,
)
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (  # noqa: E501
    ConditionalVarianceInducingPointSelector,
)
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.models.temper.gp import TemperGP
from projected_langevin_sampling_torch.models.temper.pls import TemperPLS
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_torch.parallel import initialize_multi_host

MODEL_NAMES = [
    "pls-onb",
    "pls-onb-temper",
    "pls-onb-conformalise",
    "pls-student-onb",
    "pls-student-onb-temper",
    "pls-student-onb-conformalise",
    "svgp",
    "svgp-temper",
    "svgp-conformalise",
    "svgp-student",
    "svgp-student-temper",
    "svgp-student-conformalise",
]

METRICS = ["mae", "mse", "nll", "average_interval_width", "coverage"]
DATASETS_DIR = os.path.join("experiments", "uci", "datasets")


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
        problem_type=ProblemType.REGRESSION,
        seed=seed,
        x=x,
        y=y.astype(float),
        train_data_percentage=train_data_percentage,
        validation_data_percentage=validation_data_percentage,
        normalise=True,
        device=device,
        dtype=dtype,
    )


def estimate_student_parameters(y_actual, predictions) -> tuple[float, float]:
    """Student-T df and scale fitted (``floc=0``) to the mean subsample-GP
    residuals. Near-Gaussian residuals drive the MLE df to ~1e13, where the
    likelihood is flat; a t with df 1e6 is Gaussian to ~1e-6, so df is
    capped there."""
    residuals = torch.mean(torch.stack([y_actual - p.mean for p in predictions], dim=1), dim=1)
    degrees_of_freedom, _, scale = scipy.stats.t.fit(residuals.cpu().numpy(), floc=0)
    return float(min(degrees_of_freedom, 1e6)), float(scale)


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
    models_filter: set[str] | None = None,
    datasets_dir: str = DATASETS_DIR,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> None:
    """``models_filter``: restrict the PLS/SVGP model loop to these base
    model names (e.g. ``{"svgp-student"}``), for metrics-only passes over
    partly populated output directories.

    With ``pls.parallel`` (``{"data": D, "particles": P}``) the run is one
    rank of D x P: it joins the process group first
    (``initialize_multi_host``, from torchrun's environment unless a group
    exists; NCCL, or gloo for ``device="cpu"``). Every rank computes the
    same data, GPs, inducing points and bases from the same seeds and trains
    its share of the particles. Only rank 0 writes to ``outputs_path`` and
    scores the models; the others work in a private copy of this seed's
    and dataset's data and models as they stood at the start (so every rank
    makes the same train-or-load choices), skip the metrics and the SVGPs,
    wait at a barrier for rank 0 and delete their copy."""
    if not pls_config.get("parallel"):
        _main(data_seed, dataset_name, data_config, kernel_config, inducing_points_config,
              pls_config, svgp_config, metrics_config, outputs_path, models_filter,
              datasets_dir, device, dtype, writer=True)
        return
    rank, _ = initialize_multi_host(device=device)
    if not dist.is_initialized():
        raise ValueError(f"pls.parallel={pls_config['parallel']} runs one process a rank: start "
                         "the main under torchrun (or launch_cpu_ranks on the CPU)")
    dist.barrier()  # no rank copies the tree while rank 0 writes it
    scratch = None
    if rank != 0:
        scratch = tempfile.mkdtemp(prefix=f"uci_regression_rank{rank}_")
        for part in ("data", "models"):
            src = os.path.join(outputs_path, str(data_seed), part, dataset_name)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(scratch, str(data_seed), part, dataset_name))
    try:
        _main(data_seed, dataset_name, data_config, kernel_config, inducing_points_config,
              pls_config, svgp_config, metrics_config, scratch or outputs_path, models_filter,
              datasets_dir, device, dtype, writer=rank == 0)
        dist.barrier()
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


def _main(
    data_seed: int,
    dataset_name: str,
    data_config: dict,
    kernel_config: dict,
    inducing_points_config: dict,
    pls_config: dict,
    svgp_config: dict,
    metrics_config: dict,
    outputs_path: str,
    models_filter: set[str] | None,
    datasets_dir: str,
    device,
    dtype: torch.dtype,
    writer: bool,
) -> None:
    """The run of :func:`main`; ``writer`` False skips the metrics and the
    SVGPs (a rank of a parallel run other than 0)."""
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
            path=experiment_data_path, problem_type=ProblemType.REGRESSION, device=device,
            dtype=dtype,
        )
        print(f"Loaded experiment data from {experiment_data_path=}")
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

    d = experiment_data.train.x.shape[1]
    subsample_gp_models = exact_gp_runner(
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
    likelihood = construct_average_gaussian_likelihood_from_models(subsample_gp_models)
    mean_constant = construct_average_mean_constant(subsample_gp_models)
    # opt-in (pls: mean_constant: gp): PLS takes the learned prior mean
    # constant that SVGP gets
    pls_mean_constant = float(mean_constant) if pls_config.get("mean_constant") == "gp" else 0.0
    stages.done("subsample exact GPs")

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

    def onb(**extra):
        return build_orthonormal_basis(
            kernel=pls_kernel,
            x_induce=inducing_points.x,
            x_train=experiment_data.train.x,
            scaling=pls_config.get("onb_scaling", "reference"),
            relative_eigenvalue_threshold=pls_config.get("onb_relative_eigenvalue_threshold"),
            mean_constant=pls_mean_constant,
            **extra,
        )

    onb_basis = onb()
    gaussian_cost = GaussianCost(
        observation_noise=likelihood.noise,
        y_train=experiment_data.train.y,
        link_function=IdentityLinkFunction(),
    )
    degrees_of_freedom, scale = estimate_student_parameters(
        y_actual=experiment_data.train.y,
        predictions=[m.predict_y(experiment_data.train.x) for m in subsample_gp_models],
    )
    # likelihood.noise is a variance handed to a scale parameter, as the
    # reference does (uci/regression/main.py:235-239); kept for parity
    student_onb_basis = onb(
        additional_predictive_noise_distribution=StudentTPredictiveNoise(
            df=degrees_of_freedom, loc=0.0, scale=float(likelihood.noise)
        )
    )
    student_cost = StudentTCost(
        degrees_of_freedom=degrees_of_freedom,
        y_train=experiment_data.train.y,
        link_function=IdentityLinkFunction(),
        scale=scale,
    )
    # "map": the empirical-Bayes prior-mean constant of each cost, fitted only
    # for a model that will train (a checkpoint restores its own)
    if pls_config.get("mean_constant") == "map":
        if not os.path.exists(os.path.join(models_path, "pls-onb.pkl")):
            m0_gaussian = fit_mean_constant_map(basis=onb_basis, cost=gaussian_cost)
            onb_basis = onb_basis.replace(mean_constant=m0_gaussian)
            print(f"  [mean-constant map] gaussian m0={m0_gaussian:.4f}", flush=True)
        if not os.path.exists(os.path.join(models_path, "pls-student-onb.pkl")):
            m0_student = fit_mean_constant_map(basis=student_onb_basis, cost=student_cost)
            student_onb_basis = student_onb_basis.replace(mean_constant=m0_student)
            print(f"  [mean-constant map] student m0={m0_student:.4f}", flush=True)
    stages.done("ONB builds, Student-T fit, mean constants")
    pls_dict = {
        "pls-onb": PLS(basis=onb_basis, cost=gaussian_cost),
        "pls-student-onb": PLS(basis=student_onb_basis, cost=student_cost),
    }
    coverage = metrics_config["coverage"]
    validation = experiment_data.validation
    for pls_name, pls in pls_dict.items():
        if models_filter is not None and pls_name not in models_filter:
            continue
        pls_path = os.path.join(models_path, f"{pls_name}.pkl")
        if os.path.exists(pls_path):
            particles, _, _, _ = load_pls(pls_path, pls=pls)
        else:
            particles = pls.initialise_particles(
                number_of_particles=pls_config["number_of_particles"],
                noise_only=pls_config["initial_particles_noise_only"],
                seed=pls_config["seed"],
            )
            particles, best_lr, number_of_epochs = train_pls_runner(
                pls=pls,
                particles=particles,
                particle_name=pls_name,
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
            save_pls(
                pls_path,
                particles=particles,
                observation_noise=pls.observation_noise,
                best_lr=best_lr,
                number_of_epochs=number_of_epochs,
                mean_constant=float(pls.basis.mean_constant),
                basis=pls.basis,
            )
        stages.done(f"{pls_name} step-size search")
        if not writer:
            continue
        # each model is built (and calibrated) after the previous one's
        # metrics, in the JAX main's order of draws
        for name, make_model in (
            (pls_name, lambda: pls),
            (f"{pls_name}-temper", lambda: TemperPLS(
                pls=pls, particles=particles, x_calibration=validation.x,
                y_calibration=validation.y,
                # skip the Gaussian-cost checks where the cost is not Gaussian
                debug=not isinstance(pls.cost, GaussianCost),
            )),
            (f"{pls_name}-conformalise", lambda: ConformalisePLS(
                pls=pls, particles=particles, x_calibration=validation.x,
                y_calibration=validation.y,
            )),
        ):
            calculate_metrics(
                model=make_model(),
                particles=particles,
                model_name=name,
                dataset_name=dataset_name,
                experiment_data=experiment_data,
                results_path=results_path,
                coverage=coverage,
            )
        stages.done(f"{pls_name} calibration and metrics")

    # SVGP baselines x {Gaussian, Student-T} likelihoods
    svgp_variants = {
        "svgp": GaussianLikelihood(noise=likelihood.noise),
        "svgp-student": StudentTLikelihood(
            noise=likelihood.noise, degrees_of_freedom=degrees_of_freedom
        ),
    }
    for model_name, svgp_likelihood in svgp_variants.items():
        if not writer or (models_filter is not None and model_name not in models_filter):
            continue
        svgp_path = os.path.join(models_path, f"{model_name}.pkl")
        if os.path.exists(svgp_path):
            svgp, _, _ = load_svgp(svgp_path, likelihood=svgp_likelihood, device=device)
        else:
            svgp, losses, best_learning_rate = train_svgp_runner(
                model_name=model_name,
                experiment_data=experiment_data,
                inducing_points=inducing_points,
                kernel=pls_kernel,
                likelihood=svgp_likelihood,
                seed=svgp_config["seed"],
                number_of_epochs=svgp_config["number_of_epochs"],
                batch_size=svgp_config["batch_size"],
                learning_rate_upper=svgp_config["learning_rate_upper"],
                learning_rate_lower=svgp_config["learning_rate_lower"],
                number_of_learning_rate_searches=svgp_config["number_of_learning_rate_searches"],
                is_fixed=True,
                observation_noise=float(likelihood.noise),
                mean_constant=float(mean_constant),
                early_stopper_patience=svgp_config["early_stopper_patience"],
                models_path=os.path.join(models_path, f"{model_name}-kernel-iterations"),
            )
            if svgp is None:
                print(f"SVGP training failed for {model_name=} on {dataset_name=}")
                continue
            save_svgp(svgp_path, svgp, losses, best_learning_rate)
        stages.done(f"{model_name} learning-rate search")
        for name, model in (
            (model_name, svgp),
            (f"{model_name}-temper", TemperGP(gp=svgp, x_calibration=validation.x,
                                              y_calibration=validation.y)),
            (f"{model_name}-conformalise", ConformaliseGP(gp=svgp, x_calibration=validation.x,
                                                          y_calibration=validation.y)),
        ):
            calculate_metrics(
                model=model,
                model_name=name,
                dataset_name=dataset_name,
                experiment_data=experiment_data,
                results_path=results_path,
                coverage=coverage,
            )
        stages.done(f"{model_name} calibration and metrics")


def dataset_names_of(dataset: str | None) -> list[str]:
    """``--dataset`` also takes the extra offline real datasets; the whole
    sweep is the reference's six."""
    if dataset and dataset in EXTRA_REGRESSION_DATASETS:
        return [dataset]
    if dataset:
        return [RegressionDatasetSchema(dataset).value]
    return [d.value for d in RegressionDatasetSchema]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Main script for UCI regression data experiments.")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--data_seed", type=int, required=False, default=-1)
    p.add_argument("--dataset", type=str, required=False, default=None)
    p.add_argument("--outputs_dirname", type=str, required=False, default="outputs",
                   help="outputs subdirectory (use a distinct one for non-default configs)")
    p.add_argument("--models", type=str, required=False, default=None,
                   help="comma-separated base model names (pls-onb, pls-student-onb, svgp, "
                   "svgp-student) to restrict the run to")
    p.add_argument("--datasets_dir", type=str, default=DATASETS_DIR,
                   help="directory of the <dataset>.csv files")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float64", choices=("float64", "float32"))
    return p


def cli(argv: list[str] | None = None) -> None:
    """The sweep over data seeds and datasets. A dataset that fails prints
    its traceback and the sweep goes on; each seed's tables are joined at
    its end (by rank 0 alone in a parallel run, whose group is destroyed at
    the end). A config with ``pls.parallel`` runs one process a card under
    ``torchrun --nproc-per-node D*P -m experiments_torch.uci.regression.main
    ...``, or on CPU ranks under ``launch_cpu_ranks``. In a parallel run a
    dataset that fails on one rank leaves the others waiting in a
    collective: the launcher's time limit ends them."""
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
                    models_filter=set(args.models.split(",")) if args.models else None,
                    datasets_dir=args.datasets_dir,
                    device=args.device,
                    dtype=getattr(torch, args.dtype),
                )
            except Exception as e:
                # the full traceback: a swallowed config typo otherwise turns a
                # long sweep into an exit-0 run with empty outputs
                print(f"Dataset {dataset_name} failed: {e}")
                print(traceback.format_exc())
        if not dist.is_initialized() or dist.get_rank() == 0:
            concatenate_seed(outputs_path, seed, dataset_names, MODEL_NAMES, METRICS)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    cli()
