"""1-D Poisson regression experiments (counterpart of
``experiments/curves/poisson_regression/main.py``): counts drawn at the
rate f^2 of a curve, and PLS on the ONB and IPB bases with the Poisson cost
and the square link, bimodal posteriors by construction (f and -f explain
the same rate), scored into metric CSVs.

Runs on the card (``--device cuda``) in fp64 (``--dtype float64``) unless
asked otherwise, and never moves to the CPU on its own. It writes every
results CSV and checkpoint the JAX main writes and no plot; ``main``
returns the models.

    python -m experiments_torch.curves.poisson_regression.main \\
        --config_path experiments/curves/poisson_regression/config.yaml --curve 2
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
from experiments_torch.curves.curves import Curve, curves_of, host_generator
from experiments_torch.data import Data, ExperimentData, ProblemType
from experiments_torch.metrics import calculate_metrics
from experiments_torch.preprocess import split_regression_data_intervals
from experiments_torch.utils import Stages, str2bool
from projected_langevin_sampling_torch.models.basis.inducing_point import (
    build_inducing_point_basis,
)
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import PoissonCost
from projected_langevin_sampling_torch.models.link_functions import SquareLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS


def get_experiment_data(
    curve_function: Curve,
    number_of_data_points: int,
    seed: int,
    number_of_test_intervals: int,
    total_number_of_intervals: int,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ExperimentData:
    """Counts drawn on the host from ``seed`` at the rate (2 curve)^2, which
    is ``y_untransformed``; the test intervals held out."""
    x = torch.linspace(-3, 3, number_of_data_points, dtype=dtype).reshape(-1, 1)
    y_curve = 2 * curve_function.calculate_curve(x=x).reshape(-1)
    rate = SquareLinkFunction()(y_curve)
    y = torch.poisson(rate, generator=host_generator(seed))
    (x_train, y_train, y_train_u, x_test, y_test, y_test_u) = split_regression_data_intervals(
        split_seed=curve_function.seed,
        x=x,
        y=y,
        y_untransformed=rate,
        number_of_test_intervals=number_of_test_intervals,
        total_number_of_intervals=total_number_of_intervals,
    )
    return experiment_data_on(ExperimentData(
        name=type(curve_function).__name__.lower(),
        problem_type=ProblemType.POISSON_REGRESSION,
        full=Data(x=x, y=y, y_untransformed=rate, name="full"),
        train=Data(x=x_train, y=y_train, y_untransformed=y_train_u, name="train"),
        test=Data(x=x_test, y=y_test, y_untransformed=y_test_u, name="test"),
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
    """Returns ``{"experiment_data", "pls": {name: (model, particles)}}``.
    ``svgp_config`` is read by no step, as in the JAX main."""
    refuse_gif(include_gif)
    stages = Stages(device)
    experiment_data = get_experiment_data(
        curve_function=curve_function,
        number_of_data_points=data_config["number_of_data_points"],
        seed=data_config["seed"],
        number_of_test_intervals=data_config["number_of_test_intervals"],
        total_number_of_intervals=data_config["total_number_of_intervals"],
        device=device,
        dtype=dtype,
    )
    curve_name = type(curve_function).__name__.lower()
    data_path = os.path.join(outputs_path, "data", curve_name)
    models_path = os.path.join(outputs_path, "models", curve_name)
    results_path = os.path.join(outputs_path, "results", curve_name)
    stages.done("data")

    (_, _, _, _, inducing_points, pls_kernel) = learn_kernel_and_inducing_points(
        experiment_data=experiment_data,
        kernel_config=kernel_config,
        inducing_points_config=inducing_points_config,
        models_path=models_path,
        data_path=data_path,
    )
    onb_basis = build_orthonormal_basis(
        kernel=pls_kernel,
        x_induce=inducing_points.x,
        x_train=experiment_data.train.x,
        scaling=pls_config.get("onb_scaling", "reference"),
    )
    ipb_basis = build_inducing_point_basis(
        kernel=pls_kernel,
        x_induce=inducing_points.x,
        y_induce=inducing_points.y,
        x_train=experiment_data.train.x,
    )
    stages.done("exact GP, inducing points, ONB and IPB builds")
    cost = PoissonCost(y_train=experiment_data.train.y, link_function=SquareLinkFunction())
    pls_dict = {
        "pls-onb": PLS(basis=onb_basis, cost=cost),
        "pls-ipb": PLS(basis=ipb_basis, cost=cost),
    }
    trained = {}
    for pls_name, pls in pls_dict.items():
        particles, _, _ = train_or_load_pls(
            pls=pls,
            pls_name=pls_name,
            experiment_data=experiment_data,
            pls_config=pls_config,
            models_path=models_path,
        )
        calculate_metrics(
            model=pls,
            experiment_data=experiment_data,
            model_name=pls_name,
            dataset_name=curve_name,
            results_path=results_path,
            coverage=0.95,
            particles=particles,
        )
        trained[pls_name] = (pls, particles)
        stages.done(f"{pls_name} step-size search, predictions and metrics")
    return {"experiment_data": experiment_data, "pls": trained}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Main script for toy Poisson regression experiments.")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--include_gif", type=str2bool, default=False,
                   help="GIFs of the particles: not drawn by the port (raises).")
    p.add_argument("--curve", type=int, default=None,
                   help="Run only the given curve index (1-based); default all.")
    p.add_argument("--outputs_dirname", type=str, default="outputs")
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
