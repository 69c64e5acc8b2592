"""Poisson (square-link) head-to-head quality study (counterpart of
``experiments/curves/poisson_regression/study.py``).

The Poisson main trains PLS only: there is no baseline with a square-link
Poisson likelihood. This study measures what the Poisson cost is worth on
the ten synthetic curves, with counts drawn afresh for each data seed:

    pls-onb / pls-ipb   PLS with PoissonCost and the square link
    pls-onb-m0          pls-onb with the MAP prior mean constant
    pls-onb-hs          pls-onb under a production protocol (below)
    svgp-gaussian       an SVGP with a Gaussian likelihood on the raw
                        counts, the model a practitioner falls back to

scored on the held-out intervals by the test count NLL (the log score of
each model's predictive, Poisson plug-in for PLS and Gaussian for the SVGP)
and by the rate RMSE against the true generating rate.

Each cell's rows are merged into a long CSV (columns ``curve, seed, model,
metric, split, value``, the layout pandas gives the JAX study's) under an
exclusive file lock, so interrupted sweeps resume: a cell whose rows are
there is skipped. Runs on the card (``--device cuda``) in fp64 unless asked
otherwise.

    python -m experiments_torch.curves.poisson_regression.study \\
        --config_path experiments/curves/poisson_regression/config.yaml \\
        --curves 1,2 --seeds 0,1
"""

from __future__ import annotations

import argparse
import csv
import fcntl
import math
import os

import numpy as np
import torch

from experiments_torch.config import load_config
from experiments_torch.curves.common import learn_kernel_and_inducing_points
from experiments_torch.curves.curves import CURVE_FUNCTIONS
from experiments_torch.curves.poisson_regression.main import get_experiment_data
from experiments_torch.loaders import load_pls, load_svgp, save_pls, save_svgp
from experiments_torch.metrics import _cell, _read_table, calculate_metrics
from experiments_torch.runners import train_pls_runner, train_svgp_runner
from experiments_torch.utils import create_directory
from projected_langevin_sampling_torch.models.basis.inducing_point import (
    build_inducing_point_basis,
)
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import PoissonCost
from projected_langevin_sampling_torch.models.gaussian_process import GaussianLikelihood
from projected_langevin_sampling_torch.models.link_functions import SquareLinkFunction
from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map
from projected_langevin_sampling_torch.models.pls import PLS

KEYS = ["curve", "seed", "model", "metric", "split"]
COLUMNS = KEYS + ["value"]
MODELS = ("pls-onb", "pls-onb-m0", "pls-ipb", "svgp-gaussian")

# The production-protocol variant "pls-onb-hs". The Poisson config's
# schedule (simulation_duration 0.1, early_stopper_patience 1e-3) stops
# every chain at the first energy plateau, long before the data term pulls
# the rate toward the counts; this variant trains the same model under the
# UCI protocols' budget, against the same SVGP baseline.
HS_RECIPE = dict(
    simulation_duration=0.5,
    early_stopper_patience=0.1,  # simulation-time units, 20% of the duration
    maximum_number_of_steps=1_000_000,
    number_of_step_searches=4,
    step_size_upper=1.0e-3,
    discretisation="preconditioned",
)


def _point_rate(model, particles, x):
    """Point rate on x: the Poisson predictive rate for PLS, the Gaussian
    predictive mean (the expected count) for the SVGP."""
    pred = model(x=x, particles=particles, generator=0) if isinstance(model, PLS) \
        else model.predict_y(x)
    return pred.mean.detach().cpu().numpy().reshape(-1), pred


def read_long_csv(path: str) -> list[dict]:
    """The long CSV's rows, ``seed`` an int and ``value`` a float (NaN for
    an empty cell)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        row["seed"] = int(row["seed"])
        row["value"] = float("nan") if row["value"] == "" else float(row["value"])
    return rows


def merge_rows(rows: list[dict], long_csv: str) -> None:
    """Merge ``rows`` into ``long_csv`` under an exclusive lock: a row of
    ``rows`` replaces the file's row with the same keys, and the table is
    written sorted by the keys, through a temporary file and a rename."""
    create_directory(os.path.dirname(long_csv) or ".")
    with open(long_csv + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        merged = {}
        for row in rows + (read_long_csv(long_csv) if os.path.exists(long_csv) else []):
            merged.setdefault(tuple(row[k] for k in KEYS), row)
        tmp = long_csv + ".tmp"
        with open(tmp, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(COLUMNS)
            for key in sorted(merged):
                writer.writerow([*key, _cell(merged[key]["value"])])
        os.replace(tmp, long_csv)


def _oracle_rows(name, model, particles, experiment_data, curve_name, seed):
    """Rate RMSE against the true generating rate on each split."""
    rows = []
    for split in ("train", "test"):
        data = getattr(experiment_data, split)
        if data is None or data.y_untransformed is None:
            continue
        rate_hat, _ = _point_rate(model, particles, data.x)
        true_rate = data.y_untransformed.detach().cpu().numpy().reshape(-1)
        rows.append(dict(curve=curve_name, seed=seed, model=name, metric="rate_rmse",
                         split=split, value=float(np.sqrt(np.mean((rate_hat - true_rate) ** 2)))))
    return rows


def _initial_constant(experiment_data) -> float:
    """The MAP mean constant's start, sqrt(mean count + 0.5): the square link
    is singular at f = 0."""
    return math.sqrt(float(torch.mean(experiment_data.train.y)) + 0.5)


def run_cell(
    curve_function,
    seed: int,
    config: dict,
    outputs_path: str,
    long_csv: str,
    models_requested: tuple[str, ...] = MODELS,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> None:
    """Train or load the requested models of one (curve, data seed) cell,
    write their metric CSVs and merge the cell's rows into ``long_csv``."""
    curve_name = type(curve_function).__name__.lower()
    data_config = config["data"]
    experiment_data = get_experiment_data(
        curve_function=curve_function,
        number_of_data_points=data_config["number_of_data_points"],
        seed=seed,
        number_of_test_intervals=data_config["number_of_test_intervals"],
        total_number_of_intervals=data_config["total_number_of_intervals"],
        device=device,
        dtype=dtype,
    )
    base = os.path.join(outputs_path, str(seed))
    data_path = os.path.join(base, "data", curve_name)
    models_path = os.path.join(base, "models", curve_name)
    results_path = os.path.join(base, "results", curve_name)
    for p in (data_path, models_path, results_path):
        create_directory(p)

    pls_config = config["pls"]
    coverage = config["metrics"]["coverage"] if "metrics" in config else 0.95
    cost = PoissonCost(y_train=experiment_data.train.y, link_function=SquareLinkFunction())
    models = {}
    likelihood = mean_constant = inducing_points = pls_kernel = None
    if set(models_requested) & set(MODELS):
        (_, _, likelihood, mean_constant, inducing_points, pls_kernel) = (
            learn_kernel_and_inducing_points(
                experiment_data=experiment_data,
                kernel_config=config["kernel"],
                inducing_points_config=config["inducing_points"],
                models_path=models_path,
                data_path=data_path,
            )
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
        # Without a prior mean the square-link rate reverts to f^2 -> 0 on
        # the held-out interval, while the SVGP reverts to its trained
        # constant mean: m0 gives PLS the same single empirical-Bayes scalar.
        m0 = fit_mean_constant_map(basis=onb_basis, cost=cost,
                                   initial_constant=_initial_constant(experiment_data))
        print(f"  [mean-constant map] m0={m0:.4f} (rate reversion {m0 * m0:.3f})", flush=True)
        models = {
            "pls-onb": PLS(basis=onb_basis, cost=cost),
            "pls-onb-m0": PLS(basis=onb_basis.replace(mean_constant=m0), cost=cost),
            "pls-ipb": PLS(basis=ipb_basis, cost=cost),
        }
    if "pls-onb-hs" in models_requested:
        # The production protocol: (1) the kernel learned on the
        # variance-stabilised sqrt(y + 3/8) (Anscombe), at the scale of the
        # square-link latent, not of the counts; (2) the nystrom ONB scaling
        # (threshold 1e-2) and the preconditioned discretisation; (3) the
        # UCI protocols' budget (HS_RECIPE).
        hs_models_path = os.path.join(models_path, "hs_kernel")
        hs_data_path = os.path.join(data_path, "hs_kernel")
        create_directory(hs_models_path)
        create_directory(hs_data_path)
        # the targets rounded to fp32, as the JAX study makes them
        sqrt_targets = torch.sqrt(experiment_data.train.y.float() + 0.375).to(dtype)
        (_, _, _, _, hs_inducing_points, hs_kernel) = learn_kernel_and_inducing_points(
            experiment_data=experiment_data,
            kernel_config=config["kernel"],
            inducing_points_config=config["inducing_points"],
            models_path=hs_models_path,
            data_path=hs_data_path,
            regression_targets=sqrt_targets,
        )
        hs_basis = build_orthonormal_basis(
            kernel=hs_kernel,
            x_induce=hs_inducing_points.x,
            x_train=experiment_data.train.x,
            scaling="nystrom",
            relative_eigenvalue_threshold=1e-2,
        )
        hs_m0 = fit_mean_constant_map(basis=hs_basis, cost=cost,
                                      initial_constant=_initial_constant(experiment_data))
        print(f"  [hs m0] {hs_m0:.4f} (rate reversion {hs_m0 * hs_m0:.3f})", flush=True)
        models["pls-onb-hs"] = PLS(basis=hs_basis.replace(mean_constant=hs_m0), cost=cost)
    models = {n: m for n, m in models.items() if n in models_requested}
    rows = []
    for name, pls in models.items():
        pls_path = os.path.join(models_path, f"{name}.pkl")
        if os.path.exists(pls_path):
            particles, _, _, _ = load_pls(pls_path, pls=pls)
        else:
            particles = pls.initialise_particles(
                number_of_particles=pls_config["number_of_particles"],
                noise_only=pls_config["initial_particles_noise_only"],
                seed=pls_config["seed"],
            )
            schedule = dict(pls_config)
            if name == "pls-onb-hs":
                schedule.update(HS_RECIPE)
            particles, best_lr, n_epochs = train_pls_runner(
                pls=pls,
                particle_name=name,
                experiment_data=experiment_data,
                simulation_duration=schedule["simulation_duration"],
                maximum_number_of_steps=int(schedule["maximum_number_of_steps"]),
                early_stopper_patience=schedule["early_stopper_patience"],
                number_of_step_searches=schedule["number_of_step_searches"],
                step_size_upper=schedule["step_size_upper"],
                minimum_change_in_energy_potential=schedule["minimum_change_in_energy_potential"],
                seed=schedule["seed"],
                particles=particles,
                metric_to_optimise=schedule["metric_to_optimise"],
                discretisation=schedule.get("discretisation", "euler"),
            )
            save_pls(pls_path, particles, None, best_lr, n_epochs, basis=pls.basis)
        calculate_metrics(
            model=pls,
            particles=particles,
            model_name=name,
            dataset_name=curve_name,
            experiment_data=experiment_data,
            results_path=results_path,
            coverage=coverage,
        )
        rows.extend(_oracle_rows(name, pls, particles, experiment_data, curve_name, seed))

    if "svgp-gaussian" in models_requested:
        svgp_path = os.path.join(models_path, "svgp-gaussian.pkl")
        svgp_likelihood = GaussianLikelihood(noise=likelihood.noise)
        svgp_config = config["svgp"]
        y_train = experiment_data.train.y
        print(
            f"  [svgp-gaussian inputs] noise={float(likelihood.noise):.6g} "
            f"m0={float(mean_constant):.6g} y mean={float(torch.mean(y_train)):.6g} "
            f"std={float(torch.std(y_train, correction=0)):.6g} dtype={y_train.dtype} "
            f"M={int(inducing_points.x.shape[0])}",
            flush=True,
        )
        if os.path.exists(svgp_path):
            svgp, _, _ = load_svgp(svgp_path, likelihood=svgp_likelihood, device=device)
        else:
            svgp, losses, best_learning_rate = train_svgp_runner(
                model_name="svgp-gaussian",
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
                models_path=os.path.join(models_path, "svgp-kernel-iterations"),
            )
            if svgp is not None:
                save_svgp(svgp_path, svgp, losses, best_learning_rate)
        if svgp is None:
            # every learning rate diverged: the cell keeps its PLS rows and
            # has no svgp rows
            print(f"[poisson-study] svgp-gaussian diverged at every learning rate "
                  f"({curve_name} seed={seed}) — skipping its rows", flush=True)
        else:
            calculate_metrics(
                model=svgp,
                model_name="svgp-gaussian",
                dataset_name=curve_name,
                experiment_data=experiment_data,
                results_path=results_path,
                coverage=coverage,
            )
            rows.extend(_oracle_rows("svgp-gaussian", svgp, None, experiment_data, curve_name,
                                     seed))

    # the cell's metric CSVs and oracle rows, into the long CSV
    for model in models_requested:
        for split in ("train", "test"):
            for metric in ("nll", "mse", "mae"):
                f = os.path.join(results_path, model, f"{metric}_{split}.csv")
                if not os.path.exists(f):
                    continue
                _, table = _read_table(f)
                rows.append(dict(curve=curve_name, seed=seed, model=model, metric=metric,
                                 split=split, value=table[0][1][0]))
    merge_rows(rows, long_csv)
    print(f"[poisson-study] merged {curve_name} seed={seed}", flush=True)


def missing_models(done: list[dict], curve_name: str, seed: int,
                   requested: tuple[str, ...]) -> list[str]:
    """The requested models without a test NLL row for the cell. A cell whose
    svgp baseline diverged (deterministic) counts as done for it once the
    cell completed (its pls-onb-m0 row)."""
    committed = {(r["curve"], r["seed"], r["model"]) for r in done
                 if r["metric"] == "nll" and r["split"] == "test"}
    missing = []
    for m in requested:
        if (curve_name, seed, m) in committed or (
                m == "svgp-gaussian" and (curve_name, seed, "pls-onb-m0") in committed):
            continue
        missing.append(m)
    return missing


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Poisson cost head-to-head study.")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--curves", type=str,
                   default=",".join(str(i + 1) for i in range(len(CURVE_FUNCTIONS))))
    p.add_argument("--seeds", type=str, default="0,1,2,3,4,5,6,7,8,9")
    p.add_argument("--outputs_dirname", type=str, default="outputs_study")
    p.add_argument("--models", type=str, default=",".join(MODELS),
                   help="comma list; a cell's committed rows skip their model, so e.g. "
                   "'--models pls-onb-hs' adds the production-protocol variant to cells "
                   "that have the others")
    p.add_argument("--long_csv", type=str, default=None,
                   help="the long CSV (default: poisson_study_long.csv in the outputs directory)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float64", choices=("float64", "float32"))
    return p


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    config = load_config(args.config_path)
    outputs_path = os.path.join(os.path.dirname(os.path.realpath(__file__)), args.outputs_dirname)
    long_csv = args.long_csv or os.path.join(outputs_path, "poisson_study_long.csv")
    requested = tuple(m for m in args.models.split(",") if m)
    done = read_long_csv(long_csv) if os.path.exists(long_csv) else []
    for curve_id in (int(c) for c in args.curves.split(",") if c):
        curve_function = CURVE_FUNCTIONS[curve_id - 1]
        curve_name = type(curve_function).__name__.lower()
        for seed in (int(s) for s in args.seeds.split(",") if s):
            missing = missing_models(done, curve_name, seed, requested)
            if not missing:
                print(f"[poisson-study] skip (committed): {curve_name} seed={seed}")
                continue
            run_cell(curve_function, seed, config, outputs_path, long_csv,
                     models_requested=tuple(missing), device=args.device,
                     dtype=getattr(torch, args.dtype))


if __name__ == "__main__":
    main()
