"""The curve mains, the Poisson study, the mixture summary and the profiler
of ``experiments_torch`` on one curve, with the values chip_smoke.py phase
14 holds to its limits.

Each piece runs its main through ``main(...)`` with its depth-cut config
(``experiments_torch/curves/*/config*_short.yaml``,
``experiments_torch/profiler/config_short.yaml``) in a fresh directory under
``--out``, so nothing is loaded from an earlier run, and returns what phase
14 checks: pls-onb's test MSE (the regression main writes no metrics; it is
scored here from the model the main returns, with generator 0), the metric
files of the classification and Poisson mains, the study's long CSV, the
mixture summary's row and the profiler's CSV rows. chip_smoke.py imports
these functions and drives them on the card; run alone, the script prints
one JSON line of the values (the limits of phase 14 come from a run with
``--device cpu`` on the card's machine).

  python3 scripts/curve_mains.py --device cpu --out build/curves
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from experiments_torch.config import load_config  # noqa: E402
from experiments_torch.curves.classification import main as classification  # noqa: E402
from experiments_torch.curves.curves import CURVE_FUNCTIONS  # noqa: E402
from experiments_torch.curves.mixture_likelihood import main as mixture  # noqa: E402
from experiments_torch.curves.mixture_likelihood import summarise  # noqa: E402
from experiments_torch.curves.poisson_regression import main as poisson  # noqa: E402
from experiments_torch.curves.poisson_regression import study  # noqa: E402
from experiments_torch.curves.regression import main as regression  # noqa: E402
from experiments_torch.metrics import calculate_mse  # noqa: E402
from experiments_torch.profiler import main as profiler  # noqa: E402

CURVE = 2  # each main runs one curve of the ten (1-based)
SHORT = {
    "regression": "experiments_torch/curves/regression/config_short.yaml",
    "regression_precond": "experiments_torch/curves/regression/config_precond_short.yaml",
    "classification": "experiments_torch/curves/classification/config_short.yaml",
    "poisson_regression": "experiments_torch/curves/poisson_regression/config_short.yaml",
    "mixture_likelihood": "experiments_torch/curves/mixture_likelihood/config_short.yaml",
    "profiler": "experiments_torch/profiler/config_short.yaml",
}
PLS_CLASSIFIERS = ["pls-onb-probit", "pls-ipb-probit", "pls-onb-sigmoid", "pls-ipb-sigmoid"]


def config_of(name: str) -> dict:
    return load_config(os.path.join(ROOT, SHORT[name]))


def _sections(config: dict) -> dict:
    return {f"{k}_config": v for k, v in config.items()}


def read_results(results: str, models: list[str], metrics: tuple[str, ...]) -> dict:
    """``{(model, "<metric>_<split>"): value}`` of every per-model CSV a main
    should have written; a missing file or another header raises."""
    values = {}
    for model in models:
        for metric in metrics:
            for split in ("train", "test"):
                path = os.path.join(results, model, f"{metric}_{split}.csv")
                with open(path) as f:
                    header, row = f.read().splitlines()[:2]
                if header != f"dataset,{model}":
                    raise ValueError(f"{path}: header {header!r}")
                cell = row.split(",")[1]
                values[(model, f"{metric}_{split}")] = math.nan if cell == "" else float(cell)
    return values


def run_regression(name: str, outputs: str, device) -> dict:
    """The regression main (``name``: its config); pls-onb's test MSE."""
    out = regression.main(curve_function=CURVE_FUNCTIONS[CURVE - 1], outputs_path=outputs,
                          device=device, **_sections(config_of(name)))
    test = out["experiment_data"].test
    prediction = out["pls"](x=test.x, particles=out["particles"], generator=0)
    return {"mse_test": calculate_mse(prediction, test.y)}


def run_classification(outputs: str, device) -> dict:
    """The classification main; its metric files, and the best PLS test
    accuracy."""
    classification.main(curve_function=CURVE_FUNCTIONS[CURVE - 1], outputs_path=outputs,
                        device=device, **_sections(config_of("classification")))
    values = read_results(os.path.join(outputs, "results", f"curve{CURVE}"),
                          PLS_CLASSIFIERS + ["svgp-c"], ("acc", "auc", "f1", "nll", "mae", "mse"))
    return {"values": values,
            "best_accuracy": max(values[(m, "acc_test")] for m in PLS_CLASSIFIERS)}


def run_poisson(outputs: str, device) -> dict:
    """The Poisson main; its metric files and pls-onb's test NLL."""
    poisson.main(curve_function=CURVE_FUNCTIONS[CURVE - 1], outputs_path=outputs, device=device,
                 **_sections(config_of("poisson_regression")))
    values = read_results(os.path.join(outputs, "results", f"curve{CURVE}"),
                          ["pls-onb", "pls-ipb"], ("nll", "mae", "mse"))
    return {"values": values, "nll_test": values[("pls-onb", "nll_test")]}


def run_study(outputs: str, device) -> dict:
    """One cell of the Poisson study (data seed 0) on the same curve; the
    rows of its long CSV."""
    long_csv = os.path.join(outputs, "poisson_study_long.csv")
    study.run_cell(CURVE_FUNCTIONS[CURVE - 1], 0, config_of("poisson_regression"), outputs,
                   long_csv, device=device)
    return {"rows": study.read_long_csv(long_csv)}


def run_mixture(outputs: str, device) -> dict:
    """The mixture main, then the summary of its outputs; the curve's row."""
    config_path = os.path.join(ROOT, SHORT["mixture_likelihood"])
    mixture.main(curve_function=CURVE_FUNCTIONS[CURVE - 1], outputs_path=outputs, device=device,
                 **_sections(config_of("mixture_likelihood")))
    rows = summarise.main(["--outputs_dirname", os.path.abspath(outputs),
                           "--config_path", config_path, "--device", str(device)])
    (row,) = rows
    return {"row": row, "table": os.path.join(outputs, "mixture_summary.md")}


def run_profiler(outputs: str, device) -> dict:
    """The profiler's sweeps (fp32); the rows of its CSVs as written."""
    profiler.run_sweeps(config_of("profiler"), outputs, "auto", device=device)
    rows = {}
    for axis in profiler.AXES:
        with open(os.path.join(outputs, f"{axis}.csv"), newline="") as f:
            header, *body = list(csv.reader(f))
        if header != profiler.COLUMNS:
            raise ValueError(f"{axis}.csv: header {header}")
        rows[axis] = body
    return {"rows": rows}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True,
                        help="an empty directory for the runs' outputs")
    args = parser.parse_args()
    report = {"device": args.device}
    for label, fn in (
        ("regression", lambda o: run_regression("regression", o, args.device)),
        ("regression_precond", lambda o: run_regression("regression_precond", o, args.device)),
        ("classification", lambda o: run_classification(o, args.device)),
        ("poisson_regression", lambda o: run_poisson(o, args.device)),
        ("study", lambda o: run_study(o, args.device)),
        ("mixture_likelihood", lambda o: run_mixture(o, args.device)),
        ("profiler", lambda o: run_profiler(o, args.device)),
    ):
        start = time.perf_counter()
        out = fn(os.path.join(args.out, label))
        out.pop("table", None)
        if "values" in out:
            out["values"] = {f"{m} {n}": v for (m, n), v in out["values"].items()}
        if label == "profiler":
            out = {"rows": sum(len(r) for r in out["rows"].values())}
        report[label] = {"seconds": time.perf_counter() - start, **out}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
