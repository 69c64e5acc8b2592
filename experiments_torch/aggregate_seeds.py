"""Aggregate per-seed metric CSVs into mean +- std tables (counterpart of
``experiments/aggregate_seeds.py``, with numpy and ``csv``).

The UCI mains write one CSV per metric x model x split per dataset per seed
(``outputs/<seed>/results/<dataset>/<model>/<metric>_<split>.csv``). This
collects every seed present and renders markdown tables of mean +- std over
seeds, the text the JAX script renders through pandas and tabulate, byte
for byte: the means, standard deviations and column widths are computed the
way pandas and tabulate compute them (:func:`group_mean`, :func:`group_std`,
:func:`series_mean`, :func:`series_std`, :func:`pipe_table`).

The JAX ``collect`` always unions the tree with the reference's consolidated
``results/uci_metrics_long.csv``; here that union happens only with an
explicit ``archive=`` (a long CSV as ``make_results_summary`` writes), so
the port's tables never mix in another run's numbers by default.

    python -m experiments_torch.aggregate_seeds \\
        experiments_torch/uci/regression/outputs_precond_map [--metrics nll mse] \\
        [--split test] [--archive build/summary/uci_metrics_long.csv]
"""

from __future__ import annotations

import argparse
import csv
import functools
import glob
import math
import os

import numpy as np

COLUMNS = ("dataset", "model", "metric", "seed", "value")
LONG_COLUMNS = ("task", "protocol", "split") + COLUMNS
TASKS = ("classification", "regression")
# the cell texts pandas' read_csv reads as NaN
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


class Long:
    """Rows of (dataset, model, metric, seed, value), held column by column
    in the order they were collected (the order sets the order of sums)."""

    def __init__(self, rows=()):
        rows = list(rows)
        self.columns = {c: [r[i] for r in rows] for i, c in enumerate(COLUMNS)}

    def __len__(self) -> int:
        return len(self.columns["value"])

    @property
    def empty(self) -> bool:
        return len(self) == 0

    def __getitem__(self, column: str) -> list:
        return self.columns[column]

    def rows(self) -> list[tuple]:
        return list(zip(*(self.columns[c] for c in COLUMNS)))

    def where(self, **conditions) -> Long:
        """The rows whose columns equal the given values; a set or tuple
        value is a membership test."""
        def keep(row):
            for column, wanted in conditions.items():
                value = row[COLUMNS.index(column)]
                if isinstance(wanted, (set, frozenset, tuple)):
                    if value not in wanted:
                        return False
                elif value != wanted:
                    return False
            return True

        return Long(r for r in self.rows() if keep(r))

    def union(self, other: Long) -> Long:
        """These rows, then ``other``'s, keeping the first row of each
        (dataset, model, metric, seed)."""
        seen, rows = set(), []
        for r in self.rows() + other.rows():
            if r[:4] not in seen:
                seen.add(r[:4])
                rows.append(r)
        return Long(rows)


# --- pandas' arithmetic ---------------------------------------------------------
def group_mean(values) -> float:
    """A groupby mean as pandas computes it: a Kahan-compensated sum of the
    non-NaN values in row order over their count."""
    total = compensation = 0.0
    count = 0
    for v in values:
        if v != v:
            continue
        count += 1
        y = v - compensation
        t = total + y
        compensation = t - total - y
        if compensation != compensation:
            compensation = 0.0
        total = t
    return total / count if count else math.nan


def group_std(values) -> float:
    """A groupby std (ddof 1) as pandas computes it: Welford's update over
    the non-NaN values in row order; NaN for fewer than two."""
    count, mean, m2 = 0, 0.0, 0.0
    for v in values:
        if v != v:
            continue
        count += 1
        old = mean
        mean += (v - old) / count
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (count - 1)) if count > 1 else math.nan


def series_mean(values) -> float:
    """``Series.mean()``: numpy's pairwise sum of the values with NaN set to
    0, over the count of the others."""
    v = np.asarray(values, dtype=np.float64)
    mask = np.isnan(v)
    count = int((~mask).sum())
    return float(np.where(mask, 0.0, v).sum() / count) if count else math.nan


def series_std(values) -> float:
    """``Series.std()`` (ddof 1): pandas' two-pass variance over the non-NaN
    values; NaN for fewer than two."""
    v = np.asarray(values, dtype=np.float64)
    mask = np.isnan(v)
    count = int((~mask).sum())
    if count <= 1:
        return math.nan
    v = np.where(mask, 0.0, v)
    squares = (v.sum() / count - v) ** 2
    squares[mask] = 0.0
    return float(np.sqrt(squares.sum() / (count - 1)))


def grouped(long: Long, keys: tuple[str, ...]) -> dict:
    """``{key tuple: [values in row order]}`` in sorted key order, as
    ``groupby`` iterates."""
    groups = {}
    for row in long.rows():
        key = tuple(row[COLUMNS.index(k)] for k in keys)
        groups.setdefault(key, []).append(row[4])
    return {k: groups[k] for k in sorted(groups)}


# --- reading -------------------------------------------------------------------
def parse_cell(text: str) -> float:
    """A CSV cell as pandas reads a float: its NA texts are NaN."""
    return math.nan if text.strip() in _NA else float(text)


def parse_value(text: str):
    """A CSV cell as pandas types it in a column of its kind: True or False,
    an int, a float (NaN for the NA texts) or the text."""
    if text in ("True", "False"):
        return text == "True"
    try:
        return int(text)
    except ValueError:
        try:
            return parse_cell(text)
        except ValueError:
            return text


def _first_value(path: str) -> float | None:
    """The second cell of the first data row of a per-model CSV whose header
    holds ``dataset``; None for a file that cannot be read as one."""
    try:
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        header = rows[0]
        if "dataset" not in header or len(header) < 2:
            return None
        return parse_cell(rows[1][1])
    except (OSError, UnicodeDecodeError, csv.Error, IndexError, ValueError):
        return None


@functools.lru_cache(maxsize=4)
def _archive_rows(path: str, mtime_ns: int, size: int) -> tuple:
    """A long CSV's rows (task, protocol, split, dataset, model, metric,
    seed, value); keyed on the file's time and size, so an edited file is
    read again."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        index = [header.index(c) for c in LONG_COLUMNS]
        return tuple((*(r[i] for i in index[:6]), int(r[index[6]]), parse_cell(r[index[7]]))
                     for r in reader if r)


def read_metrics_long(path: str) -> tuple:
    """The rows of a long CSV, as :func:`dump_metrics_long
    <experiments_torch.make_results_summary.dump_metrics_long>` writes it."""
    st = os.stat(path)
    return _archive_rows(os.path.realpath(path), st.st_mtime_ns, st.st_size)


def from_archive(archive: str, outputs_path: str, split: str) -> Long:
    """The archive's rows of the tree's task and protocol (the names of the
    tree's parent and of the tree) and of ``split``."""
    norm = os.path.normpath(os.path.realpath(outputs_path))
    protocol, task = os.path.basename(norm), os.path.basename(os.path.dirname(norm))
    if task not in TASKS or not os.path.exists(archive):
        return Long()
    return Long(r[3:] for r in read_metrics_long(archive)
                if r[0] == task and r[1] == protocol and r[2] == split)


def collect(outputs_path: str, split: str, archive: str | None = None) -> Long:
    """Every ``<seed>/results/<dataset>/<model>/<metric>_<split>.csv`` under
    ``outputs_path`` as rows (dataset, model, metric, seed, value); a file
    that cannot be read as a metric CSV is skipped. With ``archive``, the
    union with its rows of this tree (:func:`from_archive`), the rows on disk
    first and each (dataset, model, metric, seed) once."""
    rows = []
    for path in glob.glob(os.path.join(outputs_path, "*", "results", "*", "*",
                                       f"*_{split}.csv")):
        parts = path.split(os.sep)
        seed, dataset, model = parts[-5], parts[-3], parts[-2]
        metric = os.path.basename(path)[: -len(f"_{split}.csv")]
        value = _first_value(path)
        if value is None:
            continue
        rows.append((dataset, model, metric, int(seed), value))
    frame = Long(rows)
    archived = Long() if archive is None else from_archive(archive, outputs_path, split)
    if archived.empty:
        return frame
    if frame.empty:
        return archived
    return frame.union(archived)


# --- rendering -----------------------------------------------------------------
def pipe_table(header: list[str], rows: list[list[str]]) -> str:
    """tabulate's ``pipe`` format of text columns (``DataFrame.to_markdown``
    with every cell a string): left-aligned, each column as wide as its
    widest cell or its header plus 2."""
    widths = [max([len(h) + 2] + [len(r[i]) for r in rows]) for i, h in enumerate(header)]

    def line(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"

    return "\n".join([line(header), "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|",
                      *(line(r) for r in rows)])


def render(long: Long, metrics: list[str] | None = None) -> str:
    """Per metric, a table of datasets (sorted) by models (in the order
    first met over the sorted (dataset, model) groups): ``mean +- std (n)``,
    the std over seeds with ddof 1 (0 for one seed), n the seeds with a
    value, ``nan`` for a missing cell."""
    if long.empty:
        return "(no results found)\n"
    out = []
    for metric in metrics or sorted(set(long["metric"])):
        sub = long.where(metric=metric)
        if sub.empty:
            continue
        table = {}
        for (dataset, model), values in grouped(sub, ("dataset", "model")).items():
            std = group_std(values)
            count = sum(1 for v in values if v == v)
            table.setdefault(dataset, {})[model] = (
                f"{group_mean(values):.4f} +- {0.0 if math.isnan(std) else std:.4f} ({count})")
        models = list(dict.fromkeys(m for cells in table.values() for m in cells))
        rows = [[d, *(table[d].get(m, "nan") for m in models)] for d in sorted(table)]
        out.append(f"### {metric} (mean +- std over seeds, n in parens)\n")
        out.append(pipe_table(["", *models], rows))
        out.append("")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outputs_path")
    parser.add_argument("--metrics", nargs="*", default=None)
    parser.add_argument("--split", default="test")
    parser.add_argument("--archive", default=None,
                        help="a long CSV (make_results_summary's) to union with the tree")
    args = parser.parse_args(argv)
    print(render(collect(args.outputs_path, args.split, args.archive), args.metrics))


if __name__ == "__main__":
    main()
