"""Compare the ONB eigenvector scalings, ``reference`` against the
consistent-KKL ``nystrom``, on the ten synthetic 1-D curves, against the
SVGP baseline (counterpart of ``experiments/compare_onb_scaling.py``).

The reference's V / sqrt(M_k lambda) scaling implies the function-space
prior r(x, x) = (1/M) k(x, Z) k(Z, x), which over-shrinks the posterior mean
on smooth kernels; ``nystrom`` (V / (sqrt(M) lambda)) implies the Nystrom
prior Q_ff ~ k(x, x). The curve regression pipeline (subsample-GP kernel
learning, conditional-variance inducing points, log-spaced step-size search)
runs once per curve, and the learned kernel and inducing points are shared
by both scalings, so that the comparison isolates the scaling. ``nystrom``
is truncated at 1e-5 of the largest eigenvalue: its 1/lambda columns make
the Langevin stiffness (N / s^2) / lambda_min, and untruncated tiny
eigenvalues put the stable step below any practical grid.

Without ``--config_path`` the config is the JAX script's: the stock
``experiments/curves/regression/config.yaml`` with 6 step-size candidates, a
simulated time of 1.0 and at most 1e6 steps for every column. A config given
on the command line is used as it is (``experiments_torch/config_onb_scaling_short.yaml``
holds those settings, cut in depth only). Runs on the card in fp64 unless
asked otherwise; the data come from the port's torch generators, not
``jax.random``. The table goes to ``--out``.

    python -m experiments_torch.compare_onb_scaling --out build/onb_scaling.md [--curves 1 2]
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from experiments_torch.config import load_config
from experiments_torch.curves.common import learn_kernel_and_inducing_points
from experiments_torch.curves.curves import CURVE_FUNCTIONS, Curve
from experiments_torch.curves.regression.main import get_experiment_data
from experiments_torch.metrics import calculate_mse, calculate_nll
from experiments_torch.runners import train_pls_runner, train_svgp_runner
from experiments_torch.utils import Stages
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import GaussianCost
from projected_langevin_sampling_torch.models.gaussian_process import GaussianLikelihood
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS

STOCK_CONFIG = os.path.join("experiments", "curves", "regression", "config.yaml")
# the JAX script's changes to the stock config (compare_onb_scaling.py:177-179)
OVERRIDES = {"number_of_step_searches": 6, "simulation_duration": 1.0,
             "maximum_number_of_steps": 1e6}
SCALINGS = ("reference", "nystrom")
NYSTROM_RELATIVE_THRESHOLD = 1e-5
COLUMNS = ("reference_mse", "nystrom_mse", "svgp_mse", "reference_nll", "nystrom_nll",
           "svgp_nll")


def jax_protocol_config(path: str = STOCK_CONFIG) -> dict:
    """The stock curve regression config with the JAX script's overrides."""
    cfg = load_config(path)
    cfg["pls"].update(OVERRIDES)
    return cfg


def scaling_basis(pls_kernel, x_induce: torch.Tensor, x_train: torch.Tensor, scaling: str):
    """The ONB of ``scaling`` on the shared kernel and inducing points."""
    return build_orthonormal_basis(
        kernel=pls_kernel,
        x_induce=x_induce,
        x_train=x_train,
        scaling=scaling,
        verbose=False,
        relative_eigenvalue_threshold=(NYSTROM_RELATIVE_THRESHOLD if scaling == "nystrom"
                                       else None),
    )


def score(model, particles, data, **noise) -> tuple[float, float]:
    """``(MSE, NLL)`` of ``model``'s predictive on ``data`` (generator 0, or
    the injected ``predictive_noise`` and ``observation_noise``)."""
    prediction = model.predict(x=data.x, particles=particles, generator=0, **noise)
    return calculate_mse(prediction, data.y), calculate_nll(prediction, data.y)


def run_curve(curve_function: Curve, cfg: dict, workdir: str, device="cuda",
              dtype: torch.dtype = torch.float64) -> dict:
    """One curve's row: each scaling's and the SVGP's test MSE and NLL."""
    data_cfg, pls_cfg, svgp_cfg = cfg["data"], cfg["pls"], cfg["svgp"]
    stages = Stages(device)
    experiment_data = get_experiment_data(
        curve_function=curve_function,
        number_of_data_points=data_cfg["number_of_data_points"],
        seed=data_cfg["seed"],
        sigma_true=data_cfg["sigma_true"],
        number_of_test_intervals=data_cfg["number_of_test_intervals"],
        total_number_of_intervals=data_cfg["total_number_of_intervals"],
        validation_data_percentage=data_cfg["validation_data_percentage"],
        device=device,
        dtype=dtype,
    )
    name = experiment_data.name
    _, _, likelihood, _, inducing_points, pls_kernel = learn_kernel_and_inducing_points(
        experiment_data=experiment_data,
        kernel_config=cfg["kernel"],
        inducing_points_config=cfg["inducing_points"],
        models_path=os.path.join(workdir, name, "gp"),
        data_path=os.path.join(workdir, name, "data"),
    )
    stages.done(f"{name}: subsample exact GPs, inducing points")
    cost = GaussianCost(
        observation_noise=likelihood.noise,
        y_train=experiment_data.train.y,
        link_function=IdentityLinkFunction(),
    )
    row = {"curve": name}
    for scaling in SCALINGS:
        pls = PLS(basis=scaling_basis(pls_kernel, inducing_points.x, experiment_data.train.x,
                                      scaling), cost=cost)
        particles = pls.initialise_particles(
            number_of_particles=pls_cfg["number_of_particles"],
            noise_only=pls_cfg["initial_particles_noise_only"],
            seed=pls_cfg["seed"],
        )
        particles, _, _ = train_pls_runner(
            pls=pls,
            particles=particles,
            particle_name=f"{name}-{scaling}",
            experiment_data=experiment_data,
            simulation_duration=pls_cfg["simulation_duration"],
            maximum_number_of_steps=int(pls_cfg["maximum_number_of_steps"]),
            step_size_upper=pls_cfg["step_size_upper"],
            number_of_step_searches=pls_cfg["number_of_step_searches"],
            minimum_change_in_energy_potential=pls_cfg["minimum_change_in_energy_potential"],
            seed=pls_cfg["seed"],
            metric_to_optimise=pls_cfg["metric_to_optimise"],
            early_stopper_patience=pls_cfg["early_stopper_patience"],
        )
        row[f"{scaling}_mse"], row[f"{scaling}_nll"] = score(pls, particles,
                                                             experiment_data.test)
        stages.done(f"{name}: {scaling} (M_k {pls.basis.approximation_dimension})")
    svgp, _, _ = train_svgp_runner(
        model_name=f"{name}-svgp",
        experiment_data=experiment_data,
        inducing_points=inducing_points,
        kernel=pls_kernel,
        likelihood=GaussianLikelihood(noise=likelihood.noise),
        seed=svgp_cfg["seed"],
        number_of_epochs=svgp_cfg["number_of_epochs"],
        batch_size=svgp_cfg["batch_size"],
        learning_rate_upper=svgp_cfg["learning_rate_upper"],
        learning_rate_lower=svgp_cfg["learning_rate_lower"],
        number_of_learning_rate_searches=svgp_cfg["number_of_learning_rate_searches"],
        is_fixed=True,
        observation_noise=float(likelihood.noise),
        mean_constant=0.0,
        early_stopper_patience=svgp_cfg["early_stopper_patience"],
        models_path=os.path.join(workdir, name, "svgp"),
    )
    if svgp is not None:
        prediction = svgp.predict_y(experiment_data.test.x)
        row["svgp_mse"] = calculate_mse(prediction, experiment_data.test.y)
        row["svgp_nll"] = calculate_nll(prediction, experiment_data.test.y)
    stages.done(f"{name}: svgp")
    return row


def render(rows: list[dict]) -> str:
    """The JAX script's markdown table of ``rows``; a metric a row lacks is
    NaN."""
    out = [
        "# ONB scaling comparison — 10 synthetic curves (test split)",
        "",
        "Same learned kernel, inducing points, protocol (curve regression",
        "config with simulation_duration 1.0 and a 6-candidate step-size",
        "grid for every column — the stock 0.1 is shorter than the slowest",
        "OU mode's relaxation time) — only the ONB eigenvector scaling",
        "differs. SVGP (fixed kernel) is the baseline.",
        "",
        "| curve | ref MSE | nystrom MSE | svgp MSE | ref NLL | nystrom NLL | svgp NLL |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        r = {**dict.fromkeys(COLUMNS, math.nan), **r}
        out.append(
            "| {curve} | {reference_mse:.4f} | {nystrom_mse:.4f} | {svgp_mse:.4f} "
            "| {reference_nll:.4f} | {nystrom_nll:.4f} | {svgp_nll:.4f} |".format(**r)
        )
    return "\n".join(out) + "\n"


def counts(rows: list[dict]) -> dict:
    """The summary's counts: curves on which nystrom beats reference on NLL
    and on MSE, and on which both scalings beat the SVGP's NLL."""
    def lt(a, b):
        return a < b  # False where either is NaN

    return {
        "curves": len(rows),
        "nystrom_beats_reference_nll": sum(lt(r["nystrom_nll"], r["reference_nll"]) for r in rows),
        "nystrom_beats_reference_mse": sum(lt(r["nystrom_mse"], r["reference_mse"]) for r in rows),
        "both_beat_svgp_nll": sum(lt(r["nystrom_nll"], r.get("svgp_nll", math.nan))
                                  and lt(r["reference_nll"], r.get("svgp_nll", math.nan))
                                  for r in rows),
    }


def run(cfg: dict, curves: list[int], device="cuda",
        dtype: torch.dtype = torch.float64) -> list[dict]:
    """The rows of ``curves`` (1-based); a curve that fails is reported and
    left out, as in the JAX script."""
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        for index in curves:
            curve_function = CURVE_FUNCTIONS[index - 1]
            try:
                rows.append(run_curve(curve_function, cfg, workdir, device, dtype))
                print(rows[-1], flush=True)
            except Exception as e:  # keep the sweep alive per curve
                print(f"{type(curve_function).__name__} failed: {e}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="path of the markdown table")
    parser.add_argument("--config_path", default=None,
                        help="a config used as it is (default: the stock config with the "
                        "JAX script's overrides)")
    parser.add_argument("--curves", type=int, nargs="*", default=list(range(1, 11)))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    args = parser.parse_args(argv)
    cfg = load_config(args.config_path) if args.config_path else jax_protocol_config()
    rows = run(cfg, args.curves, args.device, getattr(torch, args.dtype))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(render(rows))
    print(f"wrote {args.out}; counts {counts(rows)}")
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
