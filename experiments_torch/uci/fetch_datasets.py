"""The offline modes of ``experiments/uci/fetch_datasets.py``, with numpy and
``csv``: write the real UCI datasets that scikit-learn bundles, or the
synthetic stand-ins.

* ``--sklearn-bundled`` rebuilds the seven z-scored frames of the JAX
  script's ``write_sklearn_bundled`` from the raw tables under
  ``experiments_torch/uci/data/sklearn/`` (copies of scikit-learn's own
  files; see the README there): ``breast_wdbc``, ``diabetes_sklearn``,
  ``digits_even``, ``wine_uci``, ``iris_binary``, ``wine_alcohol`` and
  ``iris_petal``. The features are z-scored with the mean and the ddof-1
  standard deviation pandas computes (a zero-std column is divided by 1);
  the targets are not. Each float is written in the shortest text that
  reads back to it and each integer as an integer, as pandas'
  ``to_csv(index=False)`` writes them.
* ``--synthetic`` delegates to ``make_synthetic_datasets`` (1000 rows).
* ``--pin`` writes the sha256 of every CSV in ``--out`` to
  ``<out>/checksums.json``; ``--verify`` checks the CSVs against the JAX
  script's pins (``experiments/uci/datasets/checksums.json``, read only).

The download mode of the JAX script (the UCI archive and OpenML over the
network) is not ported: asked for, it raises.

Usage:
    python -m experiments_torch.uci.fetch_datasets --sklearn-bundled --out DIR
    python -m experiments_torch.uci.fetch_datasets --synthetic --out DIR
    python -m experiments_torch.uci.fetch_datasets --verify --out DIR
"""

from __future__ import annotations

import argparse
import csv
import gzip
import hashlib
import json
import os
import sys

import numpy as np

SKLEARN_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "sklearn")
JAX_PINS = os.path.join("experiments", "uci", "datasets", "checksums.json")

# the rows of each frame (the JAX script's own counts)
SKLEARN_ROWS = {"breast_wdbc": 569, "diabetes_sklearn": 442, "digits_even": 1797,
                "wine_uci": 178, "iris_binary": 100, "wine_alcohol": 178, "iris_petal": 150}

# scikit-learn's loaders name the columns in code, not in the files
WDBC_FEATURES = [
    f"{name} error" if kind == "error" else f"{kind} {name}"
    for kind in ("mean", "error", "worst")
    for name in ("radius", "texture", "perimeter", "area", "smoothness", "compactness",
                 "concavity", "concave points", "symmetry", "fractal dimension")
]
DIABETES_FEATURES = ["age", "sex", "bmi", "bp", "s1", "s2", "s3", "s4", "s5", "s6"]
WINE_FEATURES = ["alcohol", "malic_acid", "ash", "alcalinity_of_ash", "magnesium",
                 "total_phenols", "flavanoids", "nonflavanoid_phenols", "proanthocyanins",
                 "color_intensity", "hue", "od280/od315_of_diluted_wines", "proline"]
IRIS_FEATURES = ["sepal length (cm)", "sepal width (cm)", "petal length (cm)",
                 "petal width (cm)"]


def read_bundled_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``(features (n, d) fp64, integer classes (n,))`` of a table laid out
    as scikit-learn's ``load_csv_data`` reads it: a first row ``n,d,class
    names...``, then ``d`` numbers and a class a row."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = csv.reader(f)
        n, d = (int(v) for v in next(rows)[:2])
        data, target = np.empty((n, d)), np.empty(n, dtype=int)
        for i, row in enumerate(rows):
            data[i] = np.asarray(row[:-1], dtype=np.float64)
            target[i] = int(row[-1])
    return data, target


def read_gzip_table(path: str, delimiter: str | None = None) -> np.ndarray:
    """A gzip-compressed table of numbers (``np.loadtxt``)."""
    with gzip.open(path, mode="rt", encoding="utf-8") as f:
        return np.loadtxt(f, delimiter=delimiter)


def zscore(column: np.ndarray) -> np.ndarray:
    """pandas' ``(s - s.mean()) / s.std()`` of a float column, operation for
    operation: the mean is the sum over the count, the variance sums the
    squared deviations from it over n - 1; a zero std divides by 1."""
    n = column.shape[0]
    mean = column.sum() / n
    std = np.sqrt(((mean - column) ** 2).sum() / (n - 1))
    return (column - mean) / (std if std > 0 else 1.0)


def frame(names: list[str], columns: list[np.ndarray], target: str) -> dict:
    """An ordered ``{name: column}`` with every column but ``target``
    z-scored."""
    return {name: col if name == target else zscore(col) for name, col in zip(names, columns)}


def _text(value) -> str:
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return repr(float(value))


def write_frame(path: str, table: dict) -> None:
    """``table`` as pandas' ``to_csv(index=False)`` writes it."""
    names = list(table)
    cols = [table[name].tolist() for name in names]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        for row in zip(*cols):
            writer.writerow([_text(v) for v in row])


def sklearn_bundled_frames() -> dict[str, dict]:
    """The seven frames of the JAX script's ``write_sklearn_bundled``, by
    dataset name."""
    frames, data_dir = {}, SKLEARN_DATA
    data, target = read_bundled_csv(os.path.join(data_dir, "breast_cancer.csv"))
    names = [c.replace(" ", "_") for c in WDBC_FEATURES] + ["target"]
    frames["breast_wdbc"] = frame(names, list(data.T) + [target], "target")

    data = read_gzip_table(os.path.join(data_dir, "diabetes_data_raw.csv.gz"))
    target = read_gzip_table(os.path.join(data_dir, "diabetes_target.csv.gz"))
    frames["diabetes_sklearn"] = frame(DIABETES_FEATURES + ["target"], list(data.T) + [target],
                                       "target")

    # digits even (1) against odd (0)
    data = read_gzip_table(os.path.join(data_dir, "digits.csv.gz"), delimiter=",")
    target = (data[:, -1].astype(int) % 2 == 0).astype(int)
    names = [f"px{i}" for i in range(data.shape[1] - 1)] + ["target"]
    frames["digits_even"] = frame(names, list(data[:, :-1].T) + [target], "target")

    # wine cultivar 1 (class 0) against the rest; and the alcohol content
    # regressed on the other twelve measurements
    data, target = read_bundled_csv(os.path.join(data_dir, "wine_data.csv"))
    names = [c.replace("/", "_").replace(" ", "_") for c in WINE_FEATURES]
    frames["wine_uci"] = frame(names + ["target"], list(data.T) + [(target == 0).astype(int)],
                               "target")
    frames["wine_alcohol"] = frame(names, list(data.T), "alcohol")

    # iris versicolor (class 1) against virginica (class 2), setosa dropped;
    # and the petal length regressed on the other three measurements
    data, target = read_bundled_csv(os.path.join(data_dir, "iris.csv"))
    names = [c.replace(" (cm)", "_cm").replace(" ", "_") for c in IRIS_FEATURES]
    keep = target != 0
    frames["iris_binary"] = frame(names + ["target"],
                                  list(data[keep].T) + [(target[keep] == 2).astype(int)],
                                  "target")
    frames["iris_petal"] = frame(names, list(data.T), "petal_length_cm")
    return {name: frames[name] for name in SKLEARN_ROWS}


def write_sklearn_bundled(out_dir: str) -> dict[str, int]:
    """Write ``<name>.csv`` of the seven frames into ``out_dir``; returns
    their row counts, checked against the JAX script's."""
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    for name, table in sklearn_bundled_frames().items():
        rows[name] = len(next(iter(table.values())))
        if rows[name] != SKLEARN_ROWS[name]:
            raise ValueError(f"{name}: {rows[name]} rows, expected {SKLEARN_ROWS[name]}")
        write_frame(os.path.join(out_dir, f"{name}.csv"), table)
    print(", ".join(f"wrote {name}.csv ({n} rows)" for name, n in rows.items())
          + f" to {out_dir} [REAL sklearn-bundled UCI data, z-scored features]")
    return rows


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify(out_dir: str, pins_path: str, names: list[str] | None = None) -> dict[str, bool]:
    """``{name: whether <out_dir>/<name>.csv has its pinned sha256}`` for
    every pin (or ``names``); a missing file counts as a mismatch."""
    with open(pins_path) as f:
        pins = json.load(f)
    out = {}
    for name in sorted(names or pins):
        path = os.path.join(out_dir, f"{name}.csv")
        out[name] = os.path.exists(path) and sha256(path) == pins[name]
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True, help="directory of the <name>.csv files")
    parser.add_argument("--only", nargs="*", default=None,
                        help="the datasets to download (the download mode is not ported)")
    parser.add_argument("--sklearn-bundled", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--pin", action="store_true",
                        help="sha256 every CSV in --out into <out>/checksums.json")
    parser.add_argument("--verify", action="store_true",
                        help="check the CSVs in --out against the JAX script's pins; exit 1 on "
                        "a mismatch")
    args = parser.parse_args(argv)

    if args.pin:
        pins = {os.path.splitext(f)[0]: sha256(os.path.join(args.out, f))
                for f in sorted(os.listdir(args.out)) if f.endswith(".csv")}
        path = os.path.join(args.out, "checksums.json")
        with open(path, "w") as f:
            json.dump(pins, f, indent=2, sort_keys=True)
        print(f"pinned {len(pins)} CSVs in {path}")
        return 0
    if args.verify:
        result = verify(args.out, JAX_PINS, args.only)
        for name, ok in result.items():
            print(f"{name}: {'ok' if ok else 'MISSING or sha256 mismatch'}")
        return 0 if all(result.values()) else 1
    if args.sklearn_bundled:
        write_sklearn_bundled(args.out)
        return 0
    if args.synthetic:
        from experiments_torch.uci.make_synthetic_datasets import main as synth_main

        synth_main(rows=1000, out_dir=args.out)
        return 0
    raise SystemExit(
        "fetch_datasets: the download mode (the UCI archive and OpenML) needs the network, "
        "which this port does not use; run --sklearn-bundled for the real datasets that ship "
        "in the repo, or --synthetic for the stand-ins")


if __name__ == "__main__":
    sys.exit(main())
