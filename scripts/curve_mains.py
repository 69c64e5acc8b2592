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

``--full`` runs the mains at the JAX package's configs
(``experiments/curves/*/config*.yaml``, uncut) on ``--curves`` (default all
ten) instead: each piece of ``--pieces`` in a process of its own, ``--jobs``
of them at a time on the one card, each printing one JSON line a curve (its
seconds and the test metrics of every model, as the mains write them or, for
the regression main, which writes none, scored from its models with
generator 0), then the mixture summaries and ``compare_onb_scaling`` at the
JAX protocol where chosen:

``--mixture_bands 0-9`` runs only the preconditioned mixture main (depth
cut) on the first of ``--curves`` over those PLS seeds, the values chip_smoke.py
phase 18 holds to the ranges they give:

  python3 scripts/curve_mains.py --device cpu --out build/bands --curves 1 \
      --mixture_bands 0-9

  python3 scripts/curve_mains.py --full --out chiprun_out/full --jobs 8 \
      [--pieces regression,classification] [--curves 1-10] [--dtype float32]

``--dtype`` is the mains' own (fp64 by default; float32 is the precision the
reference's record was run in); the Poisson study and ``compare_onb_scaling``
take none and stay in fp64.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys
import time

import torch

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
from experiments_torch.loaders import load_pls  # noqa: E402
from experiments_torch.metrics import calculate_mse, calculate_nll  # noqa: E402
from experiments_torch.profiler import main as profiler  # noqa: E402

CURVE = 2  # each main runs one curve of the ten (1-based)
# the JAX package's configs, uncut (--full)
FULL = {
    "regression": "experiments/curves/regression/config.yaml",
    "regression_precond": "experiments/curves/regression/config_precond.yaml",
    "classification": "experiments/curves/classification/config.yaml",
    "poisson_regression": "experiments/curves/poisson_regression/config.yaml",
    "mixture_likelihood": "experiments/curves/mixture_likelihood/config.yaml",
    "mixture_precond": "experiments/curves/mixture_likelihood/config_precond.yaml",
    "mixture_wide": "experiments/curves/mixture_likelihood/config_wide.yaml",
    "mixture_precond_wide": "experiments/curves/mixture_likelihood/config_precond_wide.yaml",
}
SHORT = {
    "regression": "experiments_torch/curves/regression/config_short.yaml",
    "regression_precond": "experiments_torch/curves/regression/config_precond_short.yaml",
    "classification": "experiments_torch/curves/classification/config_short.yaml",
    "poisson_regression": "experiments_torch/curves/poisson_regression/config_short.yaml",
    "mixture_likelihood": "experiments_torch/curves/mixture_likelihood/config_short.yaml",
    "profiler": "experiments_torch/profiler/config_short.yaml",
}
PLS_CLASSIFIERS = ["pls-onb-probit", "pls-ipb-probit", "pls-onb-sigmoid", "pls-ipb-sigmoid"]


def config_of(name: str, configs: dict = SHORT) -> dict:
    return load_config(os.path.join(ROOT, configs[name]))


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


def run_regression(name: str, outputs: str, device, curve: int = CURVE,
                   configs: dict = SHORT, dtype: torch.dtype = torch.float64) -> dict:
    """The regression main (``name``: its config); pls-onb's test MSE."""
    out = regression.main(curve_function=CURVE_FUNCTIONS[curve - 1], outputs_path=outputs,
                          device=device, dtype=dtype, **_sections(config_of(name, configs)))
    test = out["experiment_data"].test
    prediction = out["pls"](x=test.x, particles=out["particles"], generator=0)
    if configs is SHORT:
        return {"mse_test": calculate_mse(prediction, test.y)}
    # at full depth: both models' test scores and pls-onb's chosen step
    _, noise, step, epochs = load_pls(os.path.join(
        outputs, "models", f"curve{curve}", "pls-onb.pkl"), device=device)
    values = {("pls-onb", "mse_test"): calculate_mse(prediction, test.y),
              ("pls-onb", "nll_test"): calculate_nll(prediction, test.y)}
    if out["svgp"] is not None:
        svgp_prediction = out["svgp"].predict_y(test.x)
        values[("svgp-r", "mse_test")] = calculate_mse(svgp_prediction, test.y)
        values[("svgp-r", "nll_test")] = calculate_nll(svgp_prediction, test.y)
    return {"values": values, "step_size": step, "epochs": epochs,
            "observation_noise": float(noise)}


def run_classification(outputs: str, device, curve: int = CURVE, configs: dict = SHORT,
                       dtype: torch.dtype = torch.float64) -> dict:
    """The classification main; its metric files, and the best PLS test
    accuracy."""
    classification.main(curve_function=CURVE_FUNCTIONS[curve - 1], outputs_path=outputs,
                        device=device, dtype=dtype,
                        **_sections(config_of("classification", configs)))
    values = read_results(os.path.join(outputs, "results", f"curve{curve}"),
                          PLS_CLASSIFIERS + ["svgp-c"], ("acc", "auc", "f1", "nll", "mae", "mse"))
    return {"values": values,
            "best_accuracy": max(values[(m, "acc_test")] for m in PLS_CLASSIFIERS)}


def run_poisson(outputs: str, device, curve: int = CURVE, configs: dict = SHORT,
                dtype: torch.dtype = torch.float64) -> dict:
    """The Poisson main; its metric files and pls-onb's test NLL."""
    poisson.main(curve_function=CURVE_FUNCTIONS[curve - 1], outputs_path=outputs, device=device,
                 dtype=dtype, **_sections(config_of("poisson_regression", configs)))
    values = read_results(os.path.join(outputs, "results", f"curve{curve}"),
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


MIXTURE_PRECOND = "experiments_torch/curves/mixture_likelihood/config_precond_short.yaml"


def run_mixture_precond(outputs: str, device, curve: int = 1, pls_seed: int = 0,
                        dtype: torch.dtype = torch.float64) -> dict:
    """The mixture main at ``config_precond_short.yaml`` (the preconditioned
    config, GP epochs cut) on ``curve`` with PLS seed ``pls_seed`` in
    ``dtype``: the mode split and estimated shift of its particles
    (summarise's split of their train predictions, taken without predictive
    noise, whose one draw would differ between the CPU's generator and the
    card's for every seed), and its NLL, the mixture likelihood's negative
    log a train point averaged over the particles (the cost of the same
    predictions)."""
    config = load_config(os.path.join(ROOT, MIXTURE_PRECOND))
    config["pls"]["seed"] = pls_seed
    out = mixture.main(curve_function=CURVE_FUNCTIONS[curve - 1], outputs_path=outputs,
                       device=device, dtype=dtype, **_sections(config))
    pls, particles, train = out["pls"], out["particles"], out["experiment_data"].train
    predictions = pls.basis.calculate_untransformed_train_prediction_samples(particles)
    split = summarise.mode_split(f"curve{curve}", predictions, train.y,
                                 float(config["data"]["bernoulli_shift_true"]))
    cost = pls.cost.calculate_cost(predictions)
    return {**split, "nll": float(torch.mean(cost)) / train.y.shape[0],
            "finite": bool(torch.isfinite(particles).all())}


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


def _jsonable(out: dict) -> dict:
    if "values" in out:
        out["values"] = {f"{m} {n}": v for (m, n), v in out["values"].items()}
    return out


def run_full_piece(piece: str, curves: list[int], out: str, device, work: str | None = None,
                   dtype: torch.dtype = torch.float64) -> None:
    """One piece at its JAX config on ``curves``, its outputs in
    ``work/<piece>`` (default ``out``): a JSON line a curve (to stdout and
    ``out/<piece>.jsonl``), then the mixture summary, the Poisson study's
    rows (data seed 0) or the ONB-scaling table (``out/<piece>.md``). The
    mains run in ``dtype``."""
    outputs = os.path.join(work or out, piece)
    os.makedirs(outputs, exist_ok=True)
    lines = open(os.path.join(out, f"{piece}.jsonl"), "a")

    def emit(record):
        text = json.dumps(record)
        print(text, flush=True)
        lines.write(text + "\n")
        lines.flush()

    if piece == "onb_scaling":
        from experiments_torch import compare_onb_scaling

        start = time.perf_counter()
        compare_onb_scaling.main(["--out", os.path.join(out, f"{piece}.md"),
                                  "--curves", *map(str, curves), "--device", str(device)])
        emit({"piece": piece, "curves": curves, "seconds": time.perf_counter() - start})
        return
    for curve in curves:
        start = time.perf_counter()
        try:
            if piece.startswith("regression"):
                res = run_regression(piece, outputs, device, curve, FULL, dtype)
            elif piece == "classification":
                res = run_classification(outputs, device, curve, FULL, dtype)
            elif piece == "poisson_regression":
                res = run_poisson(outputs, device, curve, FULL, dtype)
            elif piece == "poisson_study":
                long_csv = os.path.join(outputs, "poisson_study_long.csv")
                study.run_cell(CURVE_FUNCTIONS[curve - 1], 0,
                               config_of("poisson_regression", FULL), outputs, long_csv,
                               device=device)
                res = {}
            else:
                mixture.main(curve_function=CURVE_FUNCTIONS[curve - 1], outputs_path=outputs,
                             device=device, dtype=dtype, **_sections(config_of(piece, FULL)))
                res = {}
        except Exception as exc:  # the other curves still run
            res = {"error": f"{type(exc).__name__}: {exc}"}
        emit({"piece": piece, "curve": curve, "seconds": time.perf_counter() - start,
              **_jsonable(res)})
    if piece.startswith("mixture"):
        rows = summarise.main(["--outputs_dirname", os.path.abspath(outputs), "--config_path",
                               os.path.join(ROOT, FULL[piece]), "--device", str(device),
                               "--dtype", str(dtype).removeprefix("torch.")])
        emit({"piece": piece, "summary": rows})
    if piece == "poisson_study":
        emit({"piece": piece, "study": study.read_long_csv(
            os.path.join(outputs, "poisson_study_long.csv"))})


def _curves(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1)) if "," not in text else [
        int(c) for c in text.split(",")]


def run_full(pieces: list[str], curves: list[int], out: str, device, jobs: int,
             work: str | None = None, deadline: float | None = None,
             dtype: str = "float64") -> None:
    """Each piece in a process of its own, ``jobs`` at a time, with the
    host's cores shared among them; past ``deadline`` seconds the pieces
    still running are stopped (their finished curves are on disk)."""
    t0 = time.perf_counter()
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // jobs)))
    env["MKL_NUM_THREADS"] = env["OMP_NUM_THREADS"]
    waiting, running = list(pieces), {}
    os.makedirs(out, exist_ok=True)
    while waiting or running:
        while waiting and len(running) < jobs:
            piece = waiting.pop(0)
            log = open(os.path.join(out, f"{piece}.log"), "w")
            cmd = [sys.executable, os.path.abspath(__file__), "--full", "--worker",
                   "--pieces", piece, "--curves", ",".join(map(str, curves)), "--out", out,
                   "--work", work or out, "--device", str(device), "--dtype", dtype]
            running[piece] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                               env=env), log, time.perf_counter())
        time.sleep(1.0)
        if deadline is not None and time.perf_counter() - t0 > deadline:
            waiting = []
            for proc, _, _ in running.values():
                proc.terminate()
        for piece, (proc, log, start) in list(running.items()):
            if proc.poll() is not None:
                log.close()
                print(json.dumps({"piece": piece, "exit": proc.returncode,
                                  "seconds": time.perf_counter() - start}), flush=True)
                del running[piece]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True,
                        help="an empty directory for the runs' outputs")
    parser.add_argument("--full", action="store_true",
                        help="the JAX package's configs, uncut, on --curves")
    parser.add_argument("--pieces", type=str,
                        default=",".join([*FULL, "poisson_study", "onb_scaling"]))
    parser.add_argument("--curves", type=str, default="1-10", help="e.g. 1-10 or 1,3")
    parser.add_argument("--jobs", type=int, default=1, help="pieces run at once (--full)")
    parser.add_argument("--work", type=str, default=None,
                        help="where the mains write their outputs (default: --out)")
    parser.add_argument("--deadline", type=float, default=None,
                        help="seconds after which the pieces still running are stopped")
    parser.add_argument("--dtype", type=str, default="float64", choices=("float64", "float32"),
                        help="the mains' --dtype (--full and --mixture_bands)")
    parser.add_argument("--mixture_bands", type=str, default=None, metavar="SEEDS",
                        help="only run_mixture_precond on --curves' first curve over these "
                        "PLS seeds (e.g. 0-4): a JSON line each, then the ranges")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.mixture_bands is not None:
        curve, rows = _curves(args.curves)[0], []
        for seed in _curves(args.mixture_bands):
            start = time.perf_counter()
            row = run_mixture_precond(os.path.join(args.out, f"seed{seed}"), args.device, curve,
                                      seed, getattr(torch, args.dtype))
            rows.append(row)
            print(json.dumps({"pls_seed": seed, "seconds": time.perf_counter() - start, **row}),
                  flush=True)
        print(json.dumps({"curve": curve, "ranges": {
            k: [min(r[k] for r in rows), max(r[k] for r in rows)]
            for k in ("n_upper", "est_shift", "nll")}}))
        return
    if args.full:
        pieces, curves = args.pieces.split(","), _curves(args.curves)
        if args.worker:
            torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
            for piece in pieces:
                run_full_piece(piece, curves, args.out, args.device, args.work,
                               getattr(torch, args.dtype))
        else:
            run_full(pieces, curves, args.out, args.device, args.jobs, args.work, args.deadline,
                     args.dtype)
        return
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
