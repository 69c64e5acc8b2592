"""1-D curve regression experiments (counterpart of
``experiments/curves/regression/main.py``): for each synthetic curve,
subsample-GP kernel learning -> greedy inducing points -> PLS (ONB, Gaussian
cost) with its step-size search -> conformal calibration -> the SVGP
baseline on the PLS kernel, also conformalised.

Runs on the card (``--device cuda``) in fp64 (``--dtype float64``, the JAX
main's default) unless asked otherwise; it never moves to the CPU on its
own. It writes the checkpoints the JAX main writes and no plot; it makes
the predictions the JAX main plots, and ``main`` returns the models.

    python -m experiments_torch.curves.regression.main \\
        --config_path experiments/curves/regression/config.yaml --curve 2
"""

from __future__ import annotations

import argparse
import os

import torch

from experiments_torch.config import load_config
from experiments_torch.curves.common import (
    experiment_data_on,
    learn_kernel_and_inducing_points,
    refuse_gif,
    train_or_load_pls,
)
from experiments_torch.curves.curves import Curve, curves_of
from experiments_torch.data import Data, ExperimentData, ProblemType
from experiments_torch.loaders import load_svgp, save_svgp
from experiments_torch.preprocess import split_regression_data_intervals, train_test_split
from experiments_torch.runners import predict_pls_1d_particles_runner, train_svgp_runner
from experiments_torch.utils import Stages, str2bool
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.conformalise import (
    ConformaliseGP,
    ConformalisePLS,
)
from projected_langevin_sampling_torch.models.costs import GaussianCost
from projected_langevin_sampling_torch.models.gaussian_process import GaussianLikelihood
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS


def get_experiment_data(
    curve_function: Curve,
    number_of_data_points: int,
    seed: int,
    sigma_true: float,
    number_of_test_intervals: int,
    total_number_of_intervals: int,
    validation_data_percentage: float,
    min_validation_data_points: int = 50,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ExperimentData:
    """The noisy curve on [-3, 3], made on the host from ``seed``; the test
    intervals held out, then a validation split of the rest (at least
    ``min_validation_data_points``), on ``device`` in ``dtype``."""
    x = torch.linspace(-3, 3, number_of_data_points, dtype=dtype).reshape(-1, 1)
    y = curve_function.regression(x=x, sigma_true=sigma_true, generator=seed)
    (x_tv, y_tv, _, x_test, y_test, _) = split_regression_data_intervals(
        split_seed=curve_function.seed,
        x=x,
        y=y,
        number_of_test_intervals=number_of_test_intervals,
        total_number_of_intervals=total_number_of_intervals,
    )
    if len(x_tv) < min_validation_data_points:
        raise ValueError(
            f"Number of training points is less than the minimum number of "
            f"validation points: {len(x_tv)} < {min_validation_data_points}"
        )
    x_train, x_validation, y_train, y_validation = (
        torch.from_numpy(a) for a in train_test_split(
            x_tv.numpy(), y_tv.numpy(),
            test_size=max(validation_data_percentage, min_validation_data_points / len(x_tv)),
            random_state=seed,
        )
    )
    return experiment_data_on(ExperimentData(
        name=type(curve_function).__name__.lower(),
        problem_type=ProblemType.REGRESSION,
        full=Data(x=x, y=y, name="full"),
        train=Data(x=x_train, y=y_train, name="train"),
        validation=Data(x=x_validation, y=y_validation, name="validation"),
        test=Data(x=x_test, y=y_test, name="test"),
    ), device, dtype)


def main(
    curve_function: Curve,
    data_config: dict,
    kernel_config: dict,
    inducing_points_config: dict,
    pls_config: dict,
    svgp_config: dict,
    outputs_path: str,
    include_gif: bool = False,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> dict:
    """Returns the models it trained or loaded: ``{"experiment_data", "pls",
    "particles", "pls_conformalised", "svgp", "svgp_conformalised"}`` (the
    SVGP entries None where every learning rate diverged)."""
    refuse_gif(include_gif)
    stages = Stages(device)
    experiment_data = get_experiment_data(
        curve_function=curve_function,
        number_of_data_points=data_config["number_of_data_points"],
        seed=data_config["seed"],
        sigma_true=data_config["sigma_true"],
        number_of_test_intervals=data_config["number_of_test_intervals"],
        total_number_of_intervals=data_config["total_number_of_intervals"],
        validation_data_percentage=data_config["validation_data_percentage"],
        device=device,
        dtype=dtype,
    )
    curve_name = type(curve_function).__name__.lower()
    data_path = os.path.join(outputs_path, "data", curve_name)
    models_path = os.path.join(outputs_path, "models", curve_name)
    stages.done("data")

    # 1-2. kernel hyperparameters from subsample exact-GP fits; greedy
    # inducing points, M = factor * N^(1/power)
    (_, _, likelihood, mean_constant, inducing_points, pls_kernel) = (
        learn_kernel_and_inducing_points(
            experiment_data=experiment_data,
            kernel_config=kernel_config,
            inducing_points_config=inducing_points_config,
            models_path=models_path,
            data_path=data_path,
        )
    )
    stages.done("subsample exact GPs, inducing points")

    # 3. PLS: ONB basis + Gaussian cost
    onb_basis = build_orthonormal_basis(
        kernel=pls_kernel,
        x_induce=inducing_points.x,
        x_train=experiment_data.train.x,
        scaling=pls_config.get("onb_scaling", "reference"),
        # opt-in (pls: mean_constant: gp): the learned GP mean constant the
        # SVGP gets
        mean_constant=float(mean_constant) if pls_config.get("mean_constant") == "gp" else 0.0,
    )
    cost = GaussianCost(
        observation_noise=likelihood.noise,
        y_train=experiment_data.train.y,
        link_function=IdentityLinkFunction(),
    )
    pls = PLS(basis=onb_basis, cost=cost, name="pls-onb")
    particles, _, _ = train_or_load_pls(
        pls=pls,
        pls_name=pls.name,
        experiment_data=experiment_data,
        pls_config=pls_config,
        models_path=models_path,
    )
    stages.done(f"{pls.name} step-size search and predictions")
    validation = experiment_data.validation
    pls_conformalised = ConformalisePLS(
        x_calibration=validation.x, y_calibration=validation.y, pls=pls, particles=particles,
    )
    predict_pls_1d_particles_runner(pls=pls_conformalised, particles=particles,
                                    experiment_data=experiment_data)
    stages.done(f"{pls.name} conformalised")

    # 4. SVGP baseline on the PLS kernel (the Titsias-equivalence config)
    model_name = "svgp-r"
    svgp_model_path = os.path.join(models_path, f"{model_name}.pkl")
    gaussian_likelihood = GaussianLikelihood(noise=likelihood.noise)
    if os.path.exists(svgp_model_path):
        svgp, _, _ = load_svgp(svgp_model_path, likelihood=gaussian_likelihood, device=device)
    else:
        svgp, losses, best_learning_rate = train_svgp_runner(
            model_name=model_name,
            experiment_data=experiment_data,
            inducing_points=inducing_points,
            kernel=pls_kernel,
            likelihood=gaussian_likelihood,
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
        if svgp is not None:
            save_svgp(svgp_model_path, svgp, losses, best_learning_rate)
    svgp_conformalised = None
    if svgp is not None:
        svgp_conformalised = ConformaliseGP(
            x_calibration=validation.x, y_calibration=validation.y, gp=svgp,
        )
        # the predictions the JAX main plots
        svgp_conformalised.predict(experiment_data.full.x, coverage=0.95)
        svgp.predict_y(experiment_data.full.x)
    stages.done(f"{model_name} learning-rate search and predictions")
    return {"experiment_data": experiment_data, "pls": pls, "particles": particles,
            "pls_conformalised": pls_conformalised, "svgp": svgp,
            "svgp_conformalised": svgp_conformalised}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Main script for toy regression experiments.")
    p.add_argument("--config_path", type=str, required=True, help="Path to the configuration file.")
    p.add_argument("--include_gif", type=str2bool, default=False,
                   help="GIFs of the particles: not drawn by the port (raises).")
    p.add_argument("--curve", type=int, default=None,
                   help="Run only the given curve index (1-based); default all.")
    p.add_argument("--outputs_dirname", type=str, default="outputs",
                   help="outputs subdirectory (use a distinct one for non-default configs)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float64", choices=("float64", "float32"))
    return p


def cli(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    config = load_config(args.config_path)
    outputs_path = os.path.join(os.path.dirname(os.path.realpath(__file__)), args.outputs_dirname)
    for curve_function in curves_of(args.curve):
        main(
            curve_function=curve_function,
            data_config=config["data"],
            kernel_config=config["kernel"],
            inducing_points_config=config["inducing_points"],
            pls_config=config["pls"],
            svgp_config=config["svgp"],
            outputs_path=outputs_path,
            include_gif=args.include_gif,
            device=args.device,
            dtype=getattr(torch, args.dtype),
        )


if __name__ == "__main__":
    cli()
