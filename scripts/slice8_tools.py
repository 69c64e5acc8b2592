"""The pieces of slice 8 of ``experiments_torch`` with the values chip_smoke.py
phase 15 holds to its limits: the real sklearn-bundled UCI data, the UCI
mains on them, the gap attribution, the SVGP audit, the ONB-scaling
comparison and the parallel regression main on a 1 x 1 mesh.

Each piece runs in a fresh directory under ``--out``, so nothing is loaded
from an earlier run, fp64, with the depth-cut configs
(``experiments_torch/uci/*/config*_short.yaml``, the mains on real data
with ``config*_real_short.yaml``,
``experiments_torch/config_onb_scaling_short.yaml``), and
returns what phase 15 checks. chip_smoke.py imports these functions and
drives them on the card; run alone, the script prints one JSON line of the
values (phase 15's limits come from a run with ``--device cpu``).

  python3 scripts/slice8_tools.py --device cpu --out build/slice8
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

import torch.distributed as dist  # noqa: E402

from experiments_torch import audit_svgp, compare_onb_scaling  # noqa: E402
from experiments_torch.config import load_config  # noqa: E402
from experiments_torch.metrics import concatenate_seed  # noqa: E402
from experiments_torch.uci import fetch_datasets, make_synthetic_datasets  # noqa: E402
from experiments_torch.uci.classification import analyse_gap  # noqa: E402
from experiments_torch.uci.classification import main as classification  # noqa: E402
from experiments_torch.uci.regression import main as regression  # noqa: E402
from projected_langevin_sampling_torch.parallel import make_mesh  # noqa: E402

SHORT = {
    "regression": "experiments_torch/uci/regression/config_precond_map_real_short.yaml",
    "classification": "experiments_torch/uci/classification/config_precond_smooth_real_short.yaml",
    "audit": "experiments_torch/uci/regression/config_precond_map_short.yaml",
    "parallel": "experiments_torch/uci/regression/config_parallel_1x1_short.yaml",
    "onb_scaling": "experiments_torch/config_onb_scaling_short.yaml",
}
# the JAX script's frames (fetch_datasets.py): rows and columns, the target
# included
SHAPES = {"breast_wdbc": (569, 31), "diabetes_sklearn": (442, 11), "digits_even": (1797, 65),
          "wine_uci": (178, 14), "iris_binary": (100, 5), "wine_alcohol": (178, 13),
          "iris_petal": (150, 4)}
REGRESSION_SET, CLASSIFICATION_SETS = "diabetes_sklearn", ("wine_uci", "breast_wdbc")
# the real-data rollup of the reference (RESULTS.md:239-300), test split,
# means over 10 seeds at the configs' full depth: (pls-onb, svgp)
REFERENCE = {("diabetes_sklearn", "nll"): (1.1094, 1.0817),
             ("diabetes_sklearn", "mse"): (0.4851, 0.5084),
             ("wine_uci", "nll"): (0.1175, 0.0710), ("wine_uci", "acc"): (0.9667, 0.9833),
             ("breast_wdbc", "nll"): (0.1141, 0.1004), ("breast_wdbc", "acc"): (0.9561, 0.9561)}
AUDIT_SETS = ("diabetes_sklearn", "energy_cooling")
ENERGY_ROWS = 768  # energy_cooling's real row count (experiments/uci/fetch_datasets.py:50)
ONB_CURVES = (2, 3)


def config_of(name: str) -> dict:
    return load_config(os.path.join(ROOT, SHORT[name]))


def _sections(config: dict) -> dict:
    return {f"{k}_config": v for k, v in config.items()}


def _value(path: str) -> float:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return math.nan if rows[1][1] == "" else float(rows[1][1])


def read_results(results: str, models: list[str]) -> dict:
    """``{(model, file name): value}`` of every per-model CSV under
    ``results``."""
    values = {}
    for model in models:
        for name in sorted(os.listdir(os.path.join(results, model))):
            values[(model, name[:-4])] = _value(os.path.join(results, model, name))
    return values


def run_fetch(outputs: str) -> dict:
    """The seven real frames; their (rows, columns) and whether each
    carries the JAX script's sha256 pin."""
    fetch_datasets.write_sklearn_bundled(outputs)
    shapes = {}
    for name in fetch_datasets.SKLEARN_ROWS:
        with open(os.path.join(outputs, f"{name}.csv"), newline="") as f:
            header, *body = list(csv.reader(f))
        shapes[name] = (len(body), len(header))
    pins = fetch_datasets.verify(outputs, os.path.join(ROOT, fetch_datasets.JAX_PINS),
                                 list(fetch_datasets.SKLEARN_ROWS))
    return {"shapes": shapes, "pins": pins}


def run_regression(datasets: str, outputs: str, device) -> dict:
    """The regression main on ``diabetes_sklearn``; its metric files."""
    regression.main(data_seed=0, dataset_name=REGRESSION_SET, outputs_path=outputs,
                    datasets_dir=datasets, device=device, **_sections(config_of("regression")))
    concatenate_seed(outputs, 0, [REGRESSION_SET], regression.MODEL_NAMES, regression.METRICS)
    return {"values": read_results(os.path.join(outputs, "0", "results", REGRESSION_SET),
                                   regression.MODEL_NAMES)}


def run_classification(datasets: str, outputs: str, device) -> dict:
    """The classification main on ``wine_uci`` and ``breast_wdbc``; their
    metric files."""
    values = {}
    for name in CLASSIFICATION_SETS:
        classification.main(data_seed=0, dataset_name=name, outputs_path=outputs,
                            datasets_dir=datasets, device=device,
                            **_sections(config_of("classification")))
        values[name] = read_results(os.path.join(outputs, "0", "results", name),
                                    classification.MODEL_NAMES)
    concatenate_seed(outputs, 0, list(CLASSIFICATION_SETS), classification.MODEL_NAMES,
                     classification.METRICS)
    return {"values": values}


def run_gap(classification_outputs: str, outputs: str, device) -> dict:
    """``analyse_gap`` on the classification main's checkpoints; its rows."""
    rows = analyse_gap.run(classification_outputs, list(CLASSIFICATION_SETS), [0],
                           config_of("classification"), os.path.join(outputs, "gap.md"),
                           device=device)
    return {"rows": rows}


def run_audit(datasets: str, outputs: str, device) -> dict:
    """``audit_svgp`` on ``diabetes_sklearn`` and the synthetic
    ``energy_cooling``, seed 0; its rows."""
    rows = audit_svgp.run_audit(list(AUDIT_SETS), [0], config_of("audit"), outputs,
                                datasets, device=device)
    with open(os.path.join(outputs, "audit_svgp.md"), "w") as f:
        f.write(audit_svgp.render(rows))
    return {"rows": rows}


def run_onb_scaling(outputs: str, device) -> dict:
    """``compare_onb_scaling`` on two curves; its rows and counts."""
    rows = compare_onb_scaling.run(config_of("onb_scaling"), list(ONB_CURVES), device=device)
    os.makedirs(outputs, exist_ok=True)
    with open(os.path.join(outputs, "onb_scaling.md"), "w") as f:
        f.write(compare_onb_scaling.render(rows))
    return {"rows": rows, "counts": compare_onb_scaling.counts(rows)}


def run_parallel(datasets: str, outputs: str, device) -> dict:
    """The regression main on ``energy_cooling`` with ``pls.parallel`` on a
    1 x 1 mesh over a world-size-1 group (NCCL on the card, gloo on the
    CPU), and the same main without ``pls.parallel``; the ``pls*`` metric
    files that differ in a single bit."""
    config = config_of("parallel")
    single = {s: dict(v) for s, v in config.items()}
    del single["pls"]["parallel"]
    created = not dist.is_initialized()
    mesh = make_mesh(1, 1, device=device)
    try:
        backend = dist.get_backend()
        regression.main(data_seed=0, dataset_name="energy_cooling",
                        outputs_path=os.path.join(outputs, "parallel"), datasets_dir=datasets,
                        device=device, **_sections(config))
    finally:
        if created:
            dist.destroy_process_group()
    regression.main(data_seed=0, dataset_name="energy_cooling",
                    outputs_path=os.path.join(outputs, "single"), datasets_dir=datasets,
                    device=device, **_sections(single))
    compared, differ = 0, []
    results = os.path.join("0", "results", "energy_cooling")
    for model in regression.MODEL_NAMES:
        if not model.startswith("pls"):
            continue
        for name in sorted(os.listdir(os.path.join(outputs, "single", results, model))):
            files = [os.path.join(outputs, tree, results, model, name)
                     for tree in ("single", "parallel")]
            texts = []
            for path in files:
                with open(path, "rb") as f:
                    texts.append(f.read())
            compared += 1
            if texts[0] != texts[1]:
                differ.append(f"{model}/{name}")
    return {"mesh": tuple(mesh.shape), "backend": backend, "compared": compared,
            "differ": differ}


def write_inputs(outputs: str) -> str:
    """The real frames and the synthetic ``energy_cooling`` (its real row
    count) in one directory."""
    fetched = run_fetch(outputs)
    make_synthetic_datasets.main(ENERGY_ROWS, outputs, names=["energy_cooling"])
    return fetched


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True,
                        help="an empty directory for the runs' outputs")
    args = parser.parse_args()
    datasets = os.path.join(args.out, "datasets")
    report = {"device": args.device}
    pieces = (
        ("fetch", lambda o: write_inputs(datasets)),
        ("regression", lambda o: run_regression(datasets, o, args.device)),
        ("classification", lambda o: run_classification(datasets, o, args.device)),
        ("gap", lambda o: run_gap(os.path.join(args.out, "classification"), o, args.device)),
        ("audit", lambda o: run_audit(datasets, o, args.device)),
        ("onb_scaling", lambda o: run_onb_scaling(o, args.device)),
        ("parallel", lambda o: run_parallel(datasets, o, args.device)),
    )
    for label, fn in pieces:
        start = time.perf_counter()
        out = fn(os.path.join(args.out, label))
        report[label] = {"seconds": time.perf_counter() - start, **out}
    report["regression"]["values"] = {f"{m} {n}": v for (m, n), v
                                      in report["regression"]["values"].items()}
    report["classification"]["values"] = {
        d: {f"{m} {n}": v for (m, n), v in vals.items()}
        for d, vals in report["classification"]["values"].items()}
    print(json.dumps(report, default=str))


if __name__ == "__main__":
    main()
