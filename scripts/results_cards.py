"""The UCI mains over data seeds on the real sklearn-bundled sets, then the
port's results pipeline over their outputs.

The regression main runs on ``diabetes_sklearn``, ``wine_alcohol`` and
``iris_petal`` with ``config_precond_map_real_short.yaml``, the
classification main on ``breast_wdbc``, ``digits_even``, ``iris_binary``
and ``wine_uci`` with ``config_precond_smooth_real_short.yaml``: all models,
fp64, the sets at full size, depth cut only as those configs cut it. Each
main writes under the protocol name the summary looks for, in ``--root``:
``uci/regression/outputs_precond_map`` and
``uci/classification/outputs_precond_smooth``. Runs already on disk are
loaded, not trained again, so a sweep can be split over several calls with
``--datasets`` and ``--seeds``.

It prints one JSON line for each (main, dataset, seed): its seconds, the B1
and B2 launches inside it and pls-onb's chosen step size. Then it writes
``aggregate_seeds``' tables of each tree, ``make_results_summary``'s
markdown and long CSV, and the real-data rollup against the reference's
(``against_reference.md``: ``RESULTS.md:239-300``, from
``results/uci_metrics_long.csv``) into ``<root>/summary/``. On the card by
default; a main none of whose sets is chosen does not run:

  python3 scripts/results_cards.py --root build/cards [--seeds 0-9] \\
      [--datasets diabetes_sklearn,wine_uci] [--device cpu] \\
      [--config regression=experiments/uci/regression/config_precond_map.yaml] \\
      [--models pls-onb,svgp] [--dtype float32] [--no_summary]

``--config MAIN=PATH`` runs a main at another config (the JAX package's own,
uncut, for instance), ``--models`` restricts the regression main's models,
``--dtype`` is the mains' own (fp64 by default; float32 is the precision
the reference's record was run in) and ``--no_summary`` leaves out the
pipeline after the mains.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import subprocess
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from experiments_torch import make_results_summary  # noqa: E402
from experiments_torch.aggregate_seeds import collect, render  # noqa: E402
from experiments_torch.config import load_config  # noqa: E402
from experiments_torch.metrics import concatenate_seed  # noqa: E402
from experiments_torch.uci import fetch_datasets  # noqa: E402
from experiments_torch.uci.classification import main as classification  # noqa: E402
from experiments_torch.uci.regression import main as regression  # noqa: E402
from projected_langevin_sampling_torch.ops.cuda import gram, spectral_train  # noqa: E402

# the reference's consolidated record, from which RESULTS.md:239-300 (the
# real-data rollup) is rendered
REFERENCE = os.path.join(ROOT, "results", "uci_metrics_long.csv")
MAINS = {
    "regression": {
        "module": regression,
        "config": "experiments_torch/uci/regression/config_precond_map_real_short.yaml",
        "protocol": "outputs_precond_map",
        "datasets": ("diabetes_sklearn", "wine_alcohol", "iris_petal"),
    },
    "classification": {
        "module": classification,
        "config": "experiments_torch/uci/classification/config_precond_smooth_real_short.yaml",
        "protocol": "outputs_precond_smooth",
        "datasets": ("breast_wdbc", "digits_even", "iris_binary", "wine_uci"),
    },
}


def tree(root: str, main_name: str) -> str:
    """The main's outputs tree under ``root``, named as the summary's
    headline protocol."""
    return os.path.join(root, "uci", main_name, MAINS[main_name]["protocol"])


def write_datasets(datasets_dir: str) -> None:
    """The seven real frames, unless they are there."""
    if not all(os.path.exists(os.path.join(datasets_dir, f"{n}.csv"))
               for n in fetch_datasets.SKLEARN_ROWS):
        fetch_datasets.write_sklearn_bundled(datasets_dir)


def run_main(main_name: str, dataset: str, seed: int, root: str, datasets_dir: str, device,
             models: set[str] | None = None, config_path: str | None = None,
             dtype: torch.dtype = torch.float64) -> dict:
    """One main on one dataset and data seed, into its tree; its seconds
    (host clock after a device sync), the B1 and B2 launches inside it and
    pls-onb's step size. ``models`` restricts the regression main's models;
    ``config_path`` replaces the main's config; ``dtype`` is the main's."""
    spec = MAINS[main_name]
    config = load_config(os.path.join(ROOT, config_path or spec["config"]))
    kwargs = {f"{k}_config": v for k, v in config.items()}
    if models is not None:
        kwargs["models_filter"] = models
    launches = (spectral_train.spectral_train.launches, gram.ard_gram_scaled.launches)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    spec["module"].main(data_seed=seed, dataset_name=dataset, outputs_path=tree(root, main_name),
                        datasets_dir=datasets_dir, device=device, dtype=dtype, **kwargs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    checkpoint = os.path.join(tree(root, main_name), str(seed), "models", dataset, "pls-onb.pkl")
    with open(checkpoint, "rb") as f:
        step_size = pickle.load(f)["best_lr"]
    return {"main": main_name, "dataset": dataset, "seed": seed, "seconds": seconds,
            "b1_launches": spectral_train.spectral_train.launches - launches[0],
            "b2_launches": gram.ard_gram_scaled.launches - launches[1],
            "step_size": step_size}


def join_seed(root: str, main_name: str, seed: int, datasets: list[str]) -> None:
    """The seed's tables over its datasets on disk, as the main's sweep
    joins them."""
    module = MAINS[main_name]["module"]
    concatenate_seed(tree(root, main_name), seed, datasets, module.MODEL_NAMES, module.METRICS)


def summarise(root: str, provenance: str) -> None:
    """``aggregate_seeds``' test-split tables of each tree,
    ``make_results_summary``'s markdown and long CSV and the rollup against
    the reference's, in ``<root>/summary``."""
    out = os.path.join(root, "summary")
    os.makedirs(out, exist_ok=True)
    for main_name in MAINS:
        with open(os.path.join(out, f"aggregate_{main_name}.md"), "w") as f:
            f.write(render(collect(tree(root, main_name), "test")))
    make_results_summary.main(["--root", root, "--out", os.path.join(out, "RESULTS.md"),
                               "--provenance", provenance])
    with open(os.path.join(out, "against_reference.md"), "w") as f:
        f.write(against_reference(root))


def against_reference(root: str, reference: str = REFERENCE) -> str:
    """The real-data rollup of the trees under ``root`` against the
    reference's (``RESULTS.md:239-300``, rendered from ``reference``, the
    same protocols' rows): per (task, metric, dataset), pls-onb's mean and
    the reference's, whether they are within 2 sqrt(s^2/n + s_ref^2/n_ref)
    of each other, and each table's winner (``sig`` when the paired t is
    significant); then, per metric, the agreeing winners, the significant
    wins of each side and the means in the band."""
    lines = ["| task | metric | dataset | pls-onb, port | pls-onb, reference | band | in band "
             "| winner, port | winner, reference |", "|---|---|---|---|---|---|---|---|---|"]
    totals = []
    for task, metrics in (("classification", ("nll", "acc", "auc", "f1")),
                          ("regression", ("nll", "mse"))):
        port = collect(tree(root, task), "test")
        ref = collect(os.path.join(root, "reference", "uci", task, MAINS[task]["protocol"]),
                      "test", reference)
        for metric in metrics:
            agree = in_band = 0
            sig = {"port": [0, 0], "reference": [0, 0]}  # [pls, svgp]
            for dataset in make_results_summary.REAL_DATASETS[task]:
                rows = {}
                for side, long in (("port", port), ("reference", ref)):
                    sel = long.where(dataset=dataset, metric=metric)
                    p, s = sel.where(model="pls-onb"), sel.where(model="svgp")
                    if p.empty or s.empty:
                        break
                    rows[side] = make_results_summary.head_to_head(p, s, metric in ("nll", "mse"))
                    if rows[side]["significant"]:
                        sig[side][rows[side]["winner"] == "svgp"] += 1
                if len(rows) < 2:
                    continue
                a, b = rows["port"], rows["reference"]
                band = 2 * math.sqrt(a["pls_std"] ** 2 / a["pls_n"]
                                     + b["pls_std"] ** 2 / b["pls_n"])
                inside = abs(a["pls_mean"] - b["pls_mean"]) <= band
                agree += a["winner"] == b["winner"]
                in_band += inside
                lines.append(
                    f"| {task} | {metric} | {dataset} | {a['pls_mean']:.4f} ({a['pls_n']}) "
                    f"| {b['pls_mean']:.4f} ({b['pls_n']}) | {band:.4f} | "
                    f"{'yes' if inside else 'NO'} | "
                    + " | ".join(r["winner"] + (" sig" if r["significant"] else "")
                                 for r in (a, b)) + " |")
            totals.append(f"- {task} {metric}: winners agree on {agree}; significant wins "
                          f"pls/svgp, port {sig['port'][0]}/{sig['port'][1]}, reference "
                          f"{sig['reference'][0]}/{sig['reference'][1]}; pls-onb means in the "
                          f"band {in_band}")
    return "\n".join(lines + [""] + totals) + "\n"


def provenance(device, dtype: str = "float64") -> str:
    """The device the mains ran on, their precision and their configs."""
    precision = {"float64": "fp64", "float32": "fp32"}[dtype]
    if torch.device(device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip()
        where = f"{torch.cuda.get_device_name(0)} ({smi}), {precision}"
    else:
        where = f"the CPU (torch {torch.__version__}), {precision}"
    return where + "; " + ", ".join(f"`{MAINS[m]['config']}`" for m in MAINS)


def _seeds(text: str) -> list[int]:
    if "-" in text:
        first, last = text.split("-")
        return list(range(int(first), int(last) + 1))
    return [int(s) for s in text.split(",")]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="directory of the outputs trees, the datasets and the summary")
    parser.add_argument("--datasets", default=None,
                        help="comma-separated names (default: every real set of each main)")
    parser.add_argument("--seeds", default="0-9", help="data seeds: 0-9 or 0,3,7")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--config", action="append", default=[],
                        help="MAIN=PATH: run that main (regression or classification) at PATH")
    parser.add_argument("--models", default=None,
                        help="comma-separated models of the regression main (default: all)")
    parser.add_argument("--dtype", default="float64", choices=("float64", "float32"),
                        help="the mains' --dtype")
    parser.add_argument("--no_summary", action="store_true",
                        help="run the mains only, not the pipeline")
    args = parser.parse_args(argv)
    configs = dict(item.split("=", 1) for item in args.config)
    if set(configs) - set(MAINS):
        parser.error(f"--config names a main that is not {sorted(MAINS)}: {sorted(configs)}")
    models = None if args.models is None else set(args.models.split(","))
    chosen = None if args.datasets is None else set(args.datasets.split(","))
    unknown = (chosen or set()) - {d for spec in MAINS.values() for d in spec["datasets"]}
    if unknown:
        parser.error(f"not a real set of either main: {sorted(unknown)}")
    datasets_dir = os.path.join(args.root, "datasets")
    write_datasets(datasets_dir)
    failed = 0
    for main_name, spec in MAINS.items():
        datasets = [d for d in spec["datasets"] if chosen is None or d in chosen]
        if not datasets:
            continue
        for seed in _seeds(args.seeds):
            for dataset in datasets:
                try:
                    record = run_main(main_name, dataset, seed, args.root, datasets_dir,
                                      args.device, models if main_name == "regression" else None,
                                      configs.get(main_name), getattr(torch, args.dtype))
                except Exception as e:  # the sweep goes on, as the mains' do
                    traceback.print_exc()
                    record = {"main": main_name, "dataset": dataset, "seed": seed,
                              "error": f"{type(e).__name__}: {e}"}
                    failed += 1
                print(json.dumps(record), flush=True)
            join_seed(args.root, main_name, seed, datasets)
    if not args.no_summary:
        summarise(args.root, provenance(args.device, args.dtype))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
