"""The spread of the port's UCI regression PLS models over training seeds.

Writes the synthetic kin8nm at ``--rows`` rows (the port's generator) into
``--out``, then runs ``experiments_torch``'s regression main there with
the short config once per seed of ``--seeds``, with its ``pls.seed`` set
to it and the PLS models of ``--models`` trained anew each
time; the split, the subsample exact GPs and the inducing points are fitted
once and reloaded. ``--max-steps`` overrides ``pls.maximum_number_of_steps``
(the depth of the step-size search). Prints one JSON line per seed: each
model's test and train MSE, its chosen step size and the run's seconds.

The main scores a PLS model on one predictive draw (generator 0). With
``--draws K`` each model is scored again on the test split over the draws
of generators 0 .. K-1, and once (generator 0) with its basis's extra
predictive noise taken off; the line adds these MSEs and, for a model with
a Student-T cost, its degrees of freedom and scale and those of its extra
predictive noise.

  python3 scripts/uci_pls_seeds.py --rows 8192 --seeds 0,1,2 \\
      --models pls-onb,pls-student-onb --out build/seeds [--max-steps 20000] \\
      [--draws 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from experiments_torch.config import load_config  # noqa: E402
from experiments_torch.metrics import calculate_mse  # noqa: E402
from experiments_torch.uci import make_synthetic_datasets  # noqa: E402
from experiments_torch.uci.regression import main as regression  # noqa: E402
from projected_langevin_sampling_torch.models.pls import PLS  # noqa: E402

CONFIG = "experiments_torch/uci/regression/config_precond_map_short.yaml"
DATASET = "kin8nm"


def mse(results, model, split):
    with open(os.path.join(results, model, f"mse_{split}.csv")) as f:
        return float(f.read().splitlines()[1].split(",")[1])


def draws_of(model, particles, test, draws):
    """Test MSEs of a PLS model over ``draws`` predictive draws, without its
    extra predictive noise, and its Student-T parameters where it has them."""
    out = {"mse_test over draws": [
        calculate_mse(model(x=test.x, particles=particles, generator=k), test.y)
        for k in range(draws)]}
    noise = getattr(model.basis, "additional_predictive_noise_distribution", None)
    if noise is not None:
        bare = PLS(basis=model.basis.replace(additional_predictive_noise_distribution=None),
                   cost=model.cost)
        out["mse_test without extra noise"] = calculate_mse(
            bare(x=test.x, particles=particles, generator=0), test.y)
        out["extra noise"] = {"df": noise.df, "scale": noise.scale}
    if hasattr(model.cost, "degrees_of_freedom"):
        out["cost"] = {"df": float(model.cost.degrees_of_freedom),
                       "scale": float(model.cost.scale)}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=8192)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--models", default="pls-onb,pls-student-onb")
    p.add_argument("--max-steps", type=float, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--draws", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    config = load_config(os.path.join(ROOT, CONFIG))
    if args.max_steps is not None:
        config["pls"]["maximum_number_of_steps"] = args.max_steps
    models = args.models.split(",")
    datasets = os.path.join(args.out, "datasets")
    make_synthetic_datasets.main(args.rows, datasets, names=[DATASET])
    outputs = os.path.join(args.out, "outputs")
    models_path = os.path.join(outputs, "0", "models", DATASET)
    results = os.path.join(outputs, "0", "results", DATASET)
    scored, calculate_metrics = {}, regression.calculate_metrics

    def recording(model, experiment_data, model_name, **kw):
        if model_name in models:
            scored[model_name] = (model, kw.get("particles"), experiment_data.test)
        return calculate_metrics(model=model, experiment_data=experiment_data,
                                 model_name=model_name, **kw)

    regression.calculate_metrics = recording
    for seed in (int(s) for s in args.seeds.split(",")):
        for model in models:
            path = os.path.join(models_path, f"{model}.pkl")
            if os.path.exists(path):
                os.remove(path)
        t0 = time.perf_counter()
        regression.main(
            data_seed=0, dataset_name=DATASET, outputs_path=outputs,
            datasets_dir=datasets, device=args.device, dtype=torch.float64,
            models_filter=set(models), data_config=config["data"],
            kernel_config=config["kernel"], inducing_points_config=config["inducing_points"],
            pls_config=dict(config["pls"], seed=seed), svgp_config=config["svgp"],
            metrics_config=config["metrics"],
        )
        row = {"seed": seed, "rows": args.rows,
               "maximum_number_of_steps": config["pls"]["maximum_number_of_steps"],
               "seconds": time.perf_counter() - t0}
        for model in models:
            with open(os.path.join(models_path, f"{model}.pkl"), "rb") as f:
                row[f"{model} step size"] = pickle.load(f)["best_lr"]
            row[f"{model} mse_test"] = mse(results, model, "test")
            row[f"{model} mse_train"] = mse(results, model, "train")
            if args.draws:
                row[model] = draws_of(*scored[model], args.draws)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
