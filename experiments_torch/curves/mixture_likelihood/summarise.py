"""Quantitative summary of the mixture-likelihood runs (counterpart of
``experiments/curves/mixture_likelihood/summarise.py``).

The data come from a curve with an unknown constant shift (present with a
Bernoulli probability), and PLS trains with the two-component MultiModal
cost. A sampler that is right keeps particles in both modes, which a
Gaussian variational posterior cannot. This script turns the saved particle
clouds of the mixture main into numbers: per curve, the particle split
across the two modes and the estimated mode separation (true value: the
configured shift). It writes the markdown table ``mixture_summary.md`` into
the outputs directory.

    python -m experiments_torch.curves.mixture_likelihood.summarise \\
        --config_path experiments/curves/mixture_likelihood/config.yaml
"""

from __future__ import annotations

import argparse
import os

import torch

from experiments_torch.config import load_config
from experiments_torch.curves.common import learn_kernel_and_inducing_points
from experiments_torch.curves.curves import CURVE_FUNCTIONS
from experiments_torch.curves.mixture_likelihood.main import get_experiment_data
from experiments_torch.loaders import load_pls
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import MultiModalCost
from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS

ROOT = os.path.dirname(os.path.realpath(__file__))


def mode_split(curve_name: str, predictions: torch.Tensor, y_train: torch.Tensor,
               shift: float) -> dict:
    """One scalar per particle, its mean untransformed prediction over the
    train inputs ``predictions`` (N, J): the mixture likelihood has modes at
    f = curve and f = curve + shift, so these cluster at {mean(curve),
    mean(curve) + shift}. The observations are unshifted, so the train data's
    mean anchors the curve mode; a particle at or above anchor + shift / 2 is
    in the shifted mode."""
    per_particle = torch.mean(predictions, dim=0)
    threshold = float(torch.mean(y_train)) + shift / 2.0
    upper = per_particle >= threshold
    n_upper = int(torch.sum(upper))
    n_lower = int(per_particle.shape[0]) - n_upper
    bimodal = 0 < n_upper < per_particle.shape[0]
    est_shift = (
        float(torch.mean(per_particle[upper]) - torch.mean(per_particle[~upper]))
        if bimodal
        else float("nan")
    )
    return {"curve": curve_name, "n_lower": n_lower, "n_upper": n_upper,
            "est_shift": est_shift, "true_shift": shift, "bimodal": bimodal}


def summarise_curve(curve_function, config: dict, outputs_path: str, device="cuda",
                    dtype: torch.dtype = torch.float64) -> dict | None:
    """The mode split of the curve's saved pls-onb particles, None without a
    checkpoint. The data, GP fits (from their checkpoints) and basis are the
    main's."""
    data_config = config["data"]
    curve_name = type(curve_function).__name__.lower()
    pls_path = os.path.join(outputs_path, "models", curve_name, "pls-onb.pkl")
    if not os.path.exists(pls_path):
        return None
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
    (_, _, _, _, inducing_points, pls_kernel) = learn_kernel_and_inducing_points(
        experiment_data=experiment_data,
        kernel_config=config["kernel"],
        inducing_points_config=config["inducing_points"],
        models_path=os.path.join(outputs_path, "models", curve_name),
        data_path=os.path.join(outputs_path, "data", curve_name),
    )
    onb_basis = build_orthonormal_basis(
        kernel=pls_kernel,
        x_induce=inducing_points.x,
        x_train=experiment_data.train.x,
        scaling=config["pls"].get("onb_scaling", "reference"),
    )
    cost = MultiModalCost(
        observation_noise=torch.tensor(data_config["sigma_true"], dtype=dtype,
                                       device=experiment_data.train.y.device),
        y_train=experiment_data.train.y,
        link_function=IdentityLinkFunction(),
        shift=data_config["bernoulli_shift_true"],
        bernoulli_noise=data_config["bernoulli_probability_true"],
    )
    pls = PLS(basis=onb_basis, cost=cost, name="pls-onb")
    particles, _, best_lr, _ = load_pls(pls_path, pls=pls)
    shift = float(data_config["bernoulli_shift_true"])
    if best_lr is None:
        # the step-size search kept no candidate: the stored particles are
        # the initialisation, not a posterior
        return {"curve": curve_name, "n_lower": None, "n_upper": None,
                "est_shift": float("nan"), "true_shift": shift, "bimodal": False,
                "no_candidate": True}
    predictions = pls.predict_untransformed_samples(particles=particles,
                                                    x=experiment_data.train.x)
    return mode_split(curve_name, predictions, experiment_data.train.y, shift)


def summary_table(rows: list[dict], shift: float) -> str:
    """The markdown fragment, a row per curve in name order."""
    lines = [
        "| curve | particles in curve mode | particles in shifted mode | "
        "estimated shift (true %.0f) | bimodal |" % shift,
        "|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: r["curve"]):
        if r.get("no_candidate"):
            lines.append(
                "| {curve} | (step-size search kept no candidate) | — | — | NO |".format(**r))
        else:
            lines.append("| {curve} | {n_lower} | {n_upper} | {est_shift:.2f} | {mark} |".format(
                mark="yes" if r["bimodal"] else "NO", **r))
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> list[dict]:
    """Summarise every curve with a checkpoint into the outputs directory's
    ``mixture_summary.md``; returns the rows."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--outputs_dirname", type=str, default="outputs",
                        help="the mixture main's outputs directory under this one (or a path)")
    parser.add_argument("--config_path", type=str,
                        default=os.path.join("experiments", "curves", "mixture_likelihood",
                                             "config.yaml"),
                        help="the main's config (the pls block's discretisation does not "
                        "affect the summary, only the data and basis)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", type=str, default="float64", choices=("float64", "float32"))
    args = parser.parse_args(argv)
    config = load_config(args.config_path)
    outputs_path = os.path.join(ROOT, args.outputs_dirname)
    rows = []
    for curve_function in CURVE_FUNCTIONS:
        row = summarise_curve(curve_function, config, outputs_path, device=args.device,
                              dtype=getattr(torch, args.dtype))
        if row is not None:
            rows.append(row)
            print(row)
    os.makedirs(outputs_path, exist_ok=True)
    path = os.path.join(outputs_path, "mixture_summary.md")
    with open(path, "w") as f:
        f.write(summary_table(rows, config["data"]["bernoulli_shift_true"]))
    print(f"wrote {path}")
    return rows


if __name__ == "__main__":
    main()
