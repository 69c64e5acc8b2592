"""Generate schema-compatible synthetic stand-in UCI CSVs (counterpart of
``experiments/uci/make_synthetic_datasets.py``), with numpy and ``csv``.

The real UCI CSVs are not shipped. This script fabricates datasets with the
column schemas of ``constants.py`` so the UCI mains run end to end: inputs
are correlated Gaussians; regression targets a random smooth function (a
sum of RBF bumps) plus noise; classification targets a logistic model of
the same. The draws and the bytes are the JAX harness's: each float in the
shortest text that reads back to it, the class labels as integers, no index
column, ``\\n`` line ends (pandas' ``to_csv(index=False)``).

Usage: python -m experiments_torch.uci.make_synthetic_datasets [--rows 1000] [--out DIR]
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import os

import numpy as np

from experiments_torch.uci.constants import (
    DATASET_SCHEMA_MAPPING,
    ClassificationDatasetSchema,
    RegressionDatasetSchema,
)


def _latent(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A random smooth function of the inputs: k RBF bumps."""
    n, d = x.shape
    k = 8
    centres = rng.normal(size=(k, d))
    weights = rng.normal(size=k) * 2.0
    lengthscale = np.sqrt(d)
    d2 = ((x[:, None, :] - centres[None, :, :]) / lengthscale) ** 2
    return np.exp(-0.5 * d2.sum(-1)) @ weights


def make_dataset(schema, rows: int, rng: np.random.Generator, classification: bool):
    """``(column names, inputs (rows, d), targets (rows,))``; integer
    targets for classification."""
    d = len(schema.input_column_names)
    # correlated inputs
    mixing = rng.normal(size=(d, d)) / np.sqrt(d)
    x = rng.normal(size=(rows, d)) @ mixing
    f = _latent(x, rng)
    if classification:
        p = 1.0 / (1.0 + np.exp(-3.0 * (f - np.median(f))))
        y = (rng.uniform(size=rows) < p).astype(int)
    else:
        y = f + 0.1 * np.std(f) * rng.normal(size=rows)
    return list(schema.input_column_names) + [schema.output_column_name], x, y


def _text(value) -> str:
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return repr(float(value))


def write_dataset(path: str, columns: list[str], x: np.ndarray, y: np.ndarray) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row, target in zip(x.tolist(), y.tolist()):
            writer.writerow([_text(v) for v in row] + [_text(target)])


def dataset_seed(name: str) -> int:
    """A stable digest of the name (not Python's ``hash``, which is salted
    per process)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def main(rows: int, out_dir: str, names: list[str] | None = None) -> None:
    """Write ``<name>.csv`` into ``out_dir`` for every dataset of the
    schemas, or for ``names``; a dataset's rows do not depend on which
    others are written."""
    os.makedirs(out_dir, exist_ok=True)
    for name_enum in list(RegressionDatasetSchema) + list(ClassificationDatasetSchema):
        if names is not None and name_enum.value not in names:
            continue
        columns, x, y = make_dataset(
            DATASET_SCHEMA_MAPPING[name_enum],
            rows,
            np.random.default_rng(dataset_seed(name_enum.value)),
            classification=isinstance(name_enum, ClassificationDatasetSchema),
        )
        path = os.path.join(out_dir, f"{name_enum.value}.csv")
        write_dataset(path, columns, x, y)
        print(f"wrote {path} ({rows} rows, {len(columns)} cols) [SYNTHETIC]")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=1000)
    parser.add_argument("--out", type=str, default=os.path.join("experiments", "uci", "datasets"))
    args = parser.parse_args()
    main(args.rows, args.out)
