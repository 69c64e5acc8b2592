"""Bimodal mixture-likelihood experiments (counterpart of
``experiments/curves/mixture_likelihood/main.py``): data from a curve with
Gaussian noise whose underlying function carries an unknown constant shift
(present with a Bernoulli probability), and PLS on the ONB with the
two-component MultiModal cost from a bimodal particle initialisation.

Runs on the card (``--device cuda``) in fp64 (``--dtype float64``) unless
asked otherwise, and never moves to the CPU on its own. It writes the
checkpoints the JAX main writes and no plot; ``main`` returns the model.

    python -m experiments_torch.curves.mixture_likelihood.main \\
        --config_path experiments/curves/mixture_likelihood/config.yaml --curve 2
"""

from __future__ import annotations

import argparse
import math
import os

import torch

from experiments_torch.config import load_config
from experiments_torch.curves.common import (
    learn_kernel_and_inducing_points,
    refuse_gif,
    train_or_load_pls,
)
from experiments_torch.curves.curves import Curve, curves_of, host_generator
from experiments_torch.data import ExperimentData, ProblemType
from experiments_torch.preprocess import set_up_experiment
from experiments_torch.utils import Stages, str2bool
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import MultiModalCost
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.utils.prng import GeneratorLike


def get_experiment_data(
    curve_function: Curve,
    number_of_data_points: int,
    seed: int,
    bernoulli_probability_true: float,
    bernoulli_shift_true: float,
    sigma_true: float,
    train_data_percentage: float,
    validation_data_percentage: float,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ExperimentData:
    """The curve (times 2) plus Gaussian noise drawn on the host from
    ``seed``, split without normalising; the full split's
    ``y_untransformed`` is the curve shifted by ``bernoulli_shift_true``
    times one Bernoulli draw (from the curve's seed)."""
    x = torch.linspace(-3, 3, number_of_data_points, dtype=dtype).reshape(-1, 1)
    y_curve = 2 * curve_function.calculate_curve(x=x).reshape(-1)
    bernoulli_noise = torch.bernoulli(
        torch.tensor(bernoulli_probability_true, dtype=dtype),
        generator=host_generator(curve_function.seed),
    )
    gaussian_noise = torch.randn(y_curve.shape, generator=host_generator(seed), dtype=dtype)
    y = y_curve + sigma_true * gaussian_noise
    experiment_data = set_up_experiment(
        name=curve_function.__name__,
        problem_type=ProblemType.MULTIMODAL_REGRESSION,
        seed=seed,
        x=x,
        y=y,
        train_data_percentage=train_data_percentage,
        validation_data_percentage=validation_data_percentage,
        normalise=False,
        device=device,
        dtype=dtype,
    )
    experiment_data.full.y_untransformed = (
        y_curve + bernoulli_shift_true * bernoulli_noise
    ).to(experiment_data.full.x.device)
    return experiment_data


def generate_init_particles(
    initial_particle_noise: float,
    approximation_dimension: int,
    number_of_particles: int,
    initial_particles_lower: float,
    initial_particles_shift_scale: float,
    bernoulli_shift_true: float,
    basis_dimension: int,
    basis_eigenvectors: torch.Tensor,
    basis_eigenvalues: torch.Tensor,
    generator: GeneratorLike = 0,
    normals: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bimodal particle initialisation: function values spread evenly from
    ``initial_particles_lower`` to ``shift_scale * shift`` over the
    particles, plus small noise, pushed back into eigencoordinates as
    sqrt(M) V^T (init / sqrt(lambda)). The (M_k, J) standard normals are
    drawn on the host from ``generator``; ``normals`` injects them."""
    dtype, device = basis_eigenvalues.dtype, basis_eigenvalues.device
    if normals is None:
        normals = torch.randn((approximation_dimension, number_of_particles),
                              generator=host_generator(generator), dtype=dtype)
    init = initial_particle_noise * normals.to(device=device, dtype=dtype)
    init = init + torch.linspace(
        initial_particles_lower,
        initial_particles_shift_scale * bernoulli_shift_true,
        number_of_particles,
        dtype=dtype,
        device=device,
    )[None, :]
    return (
        math.sqrt(basis_dimension)
        * basis_eigenvectors.T
        @ (init / torch.sqrt(basis_eigenvalues)[:, None])
    )


def main(
    curve_function: Curve,
    data_config: dict,
    kernel_config: dict,
    inducing_points_config: dict,
    pls_config: dict,
    outputs_path: str,
    include_gif: bool = False,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> dict:
    """Returns ``{"experiment_data", "pls", "particles"}``."""
    refuse_gif(include_gif)
    stages = Stages(device)
    experiment_data = get_experiment_data(
        curve_function=curve_function,
        number_of_data_points=data_config["number_of_data_points"],
        seed=data_config["seed"],
        bernoulli_probability_true=data_config["bernoulli_probability_true"],
        bernoulli_shift_true=data_config["bernoulli_shift_true"],
        sigma_true=data_config["sigma_true"],
        train_data_percentage=data_config["train_data_percentage"],
        validation_data_percentage=data_config["validation_data_percentage"],
        device=device,
        dtype=dtype,
    )
    curve_name = type(curve_function).__name__.lower()
    data_path = os.path.join(outputs_path, "data", curve_name)
    models_path = os.path.join(outputs_path, "models", curve_name)
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
    stages.done("exact GP, inducing points, ONB build")
    cost = MultiModalCost(
        observation_noise=torch.tensor(data_config["sigma_true"], dtype=dtype,
                                       device=experiment_data.train.y.device),
        y_train=experiment_data.train.y,
        link_function=IdentityLinkFunction(),
        shift=data_config["bernoulli_shift_true"],
        bernoulli_noise=data_config["bernoulli_probability_true"],
    )
    pls = PLS(basis=onb_basis, cost=cost, name="pls-onb")
    init_particles = generate_init_particles(
        initial_particle_noise=pls_config["initial_particle_noise"],
        approximation_dimension=onb_basis.approximation_dimension,
        number_of_particles=pls_config["number_of_particles"],
        initial_particles_lower=pls_config["initial_particles_lower"],
        initial_particles_shift_scale=pls_config["initial_particles_shift_scale"],
        bernoulli_shift_true=data_config["bernoulli_shift_true"],
        basis_dimension=onb_basis.x_induce.shape[0],
        basis_eigenvectors=onb_basis.eigenvectors,
        basis_eigenvalues=onb_basis.eigenvalues,
        generator=pls_config["seed"],
    )
    particles, _, _ = train_or_load_pls(
        pls=pls,
        pls_name=pls.name,
        experiment_data=experiment_data,
        pls_config=pls_config,
        models_path=models_path,
        particles=init_particles,
    )
    stages.done(f"{pls.name} step-size search and predictions")
    return {"experiment_data": experiment_data, "pls": pls, "particles": particles}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Main script for mixture likelihood experiments.")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--include_gif", type=str2bool, default=False,
                   help="GIFs of the particles: not drawn by the port (raises).")
    p.add_argument("--curve", type=int, default=None,
                   help="Run only the given curve index (1-based); default all.")
    p.add_argument("--outputs_dirname", type=str, default="outputs",
                   help="Output directory name (variant runs, e.g. the preconditioned protocol).")
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
            outputs_path=outputs_path,
            include_gif=args.include_gif,
            device=args.device,
            dtype=getattr(torch, args.dtype),
        )


if __name__ == "__main__":
    cli()
