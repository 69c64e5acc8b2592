"""Metrics and their CSV files (counterpart of ``experiments/metrics.py``).

Metric dispatch follows the predictive distribution's type; results land as
one CSV per metric, model and split, and ``concatenate_metrics`` joins them
across datasets into one table per metric and split. Accuracy, ROC AUC and
F1 are numpy rebuilds of scikit-learn's (which the JAX harness calls), the
CSVs are written with ``csv`` in the layout pandas gives the JAX harness's,
and the conformal NLL uses scipy. No plots are drawn.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np
import scipy.stats
import torch

from experiments_torch.data import ExperimentData
from experiments_torch.utils import create_directory
from projected_langevin_sampling_torch.models.conformalise.base import (
    ConformaliseBase,
    ConformalPrediction,
)
from projected_langevin_sampling_torch.models.distributions import (
    Bernoulli,
    MultivariateNormal,
    Poisson,
    StudentTMarginals,
)
from projected_langevin_sampling_torch.models.gaussian_process import SVGP, ExactGP
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.models.temper.base import TemperBase


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _point_estimate(prediction) -> torch.Tensor:
    if isinstance(prediction, MultivariateNormal):
        return prediction.mean
    if isinstance(prediction, Bernoulli):
        return prediction.probs
    if isinstance(prediction, Poisson):
        return prediction.rate
    if isinstance(prediction, StudentTMarginals):
        return prediction.loc
    if isinstance(prediction, ConformalPrediction):
        return prediction.mean
    raise ValueError(f"Prediction type {type(prediction)} not supported")


def calculate_mae(prediction, y) -> float:
    return float(torch.mean(torch.abs(_point_estimate(prediction) - y)))


def calculate_mse(prediction, y) -> float:
    return float(torch.mean(torch.square(_point_estimate(prediction) - y)))


def calculate_acc(probs, y) -> float:
    """Accuracy at the 0.5 threshold (``probs.round()``, half to even), the
    one definition the step-size search and the metric CSVs share."""
    return float(np.mean(_host(y) == np.round(_host(probs))))


def calculate_auc(probs, y) -> float:
    """ROC AUC by average ranks (the Mann-Whitney statistic), so tied scores
    count half, as scikit-learn's trapezoid over its ROC curve does."""
    y, probs = _host(y), _host(probs)
    positive = y == 1
    n_pos, n_neg = int(positive.sum()), int((~positive).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined "
                         "in that case.")
    ranks = scipy.stats.rankdata(probs)
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def calculate_f1(probs, y) -> float:
    """F1 of the positive class at ``probs.round()``; 0 where it has no true
    or predicted positive, as scikit-learn's default."""
    y, predicted = _host(y) == 1, np.round(_host(probs)) == 1
    true_positive = int(np.sum(y & predicted))
    denominator = int(np.sum(y)) + int(np.sum(predicted))
    return 0.0 if denominator == 0 else float(2 * true_positive / denominator)


def calculate_nll(prediction, y) -> float:
    """The mean marginal NLL of the prediction; a conformal prediction is
    scored as a Gaussian whose std is half its 2/3-coverage interval."""
    if isinstance(prediction, (MultivariateNormal, Bernoulli, Poisson, StudentTMarginals)):
        return float(prediction.negative_log_likelihood(y))
    if isinstance(prediction, ConformalPrediction):
        if prediction.coverage != 2 / 3:
            raise ValueError(f"NLL calculation needs 2/3 coverage, got {prediction.coverage=}")
        std = (_host(prediction.upper) - _host(prediction.lower)) / 2
        return float(np.mean(-scipy.stats.norm.logpdf(_host(y), loc=_host(prediction.mean),
                                                      scale=std)))
    raise ValueError(f"Prediction type {type(prediction)} not supported")


def calculate_coverage(prediction: ConformalPrediction, y) -> float:
    y = _host(y)
    return float(np.mean((_host(prediction.lower) <= y) & (y <= _host(prediction.upper))))


def calculate_average_interval_width(model: ConformaliseBase, x, coverage: float) -> float:
    return model.calculate_average_interval_width(x=x, coverage=coverage)


def calculate_median_interval_width(model: ConformaliseBase, x, coverage: float) -> float:
    lower, upper = model.predict_coverage(x=x, coverage=coverage)
    return float(np.median(_host(upper - lower)))


def _cell(value: float) -> str:
    """A value as pandas writes a float64 cell: the shortest text that
    reads back to it, empty for NaN."""
    return "" if math.isnan(value) else repr(float(value))


def _write_table(path: str, columns: list[str], rows: list[tuple[str, list[float]]]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["dataset", *columns])
        for index, values in rows:
            writer.writerow([index, *(_cell(v) for v in values)])


def _read_table(path: str) -> tuple[list[str], list[tuple[str, list[float]]]]:
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    if header[0] != "dataset":
        raise ValueError(f"{path}: the first column is {header[0]!r}, not 'dataset'")
    return header[1:], [(row[0], [float("nan") if v == "" else float(v) for v in row[1:]])
                        for row in body]


def _write(value: float, results_path: str, model_name: str, dataset_name: str, fname: str):
    _write_table(os.path.join(results_path, model_name, fname), [model_name],
                 [(dataset_name, [value])])


def calculate_metrics(
    model,
    experiment_data: ExperimentData,
    model_name: str,
    dataset_name: str,
    results_path: str,
    coverage: float,
    particles=None,
) -> None:
    """Evaluate a model on the train and test splits, writing one CSV per
    metric under ``results_path/model_name``."""
    assert experiment_data.train is not None and experiment_data.test is not None
    create_directory(os.path.join(results_path, model_name))
    for data in [experiment_data.train, experiment_data.test]:
        if isinstance(model, (SVGP, ExactGP)):
            prediction = model.predict_y(data.x)
        elif isinstance(model, ConformaliseBase):
            prediction = model(x=data.x, coverage=coverage)
        elif isinstance(model, TemperBase):
            prediction = model(x=data.x)
        elif isinstance(model, PLS) and particles is not None:
            prediction = model(x=data.x, particles=particles, generator=0)
        else:
            raise ValueError(f"Model type {type(model)} not supported")

        write = lambda value, metric: _write(  # noqa: E731
            value, results_path, model_name, dataset_name, f"{metric}_{data.name}.csv")
        write(calculate_mae(prediction=prediction, y=data.y), "mae")
        write(calculate_mse(prediction=prediction, y=data.y), "mse")
        if isinstance(prediction, ConformalPrediction):
            write(calculate_coverage(prediction=prediction, y=data.y), "coverage")
        if isinstance(model, ConformaliseBase):
            nll = calculate_nll(prediction=model(x=data.x, coverage=2 / 3), y=data.y)
        else:
            nll = calculate_nll(prediction=prediction, y=data.y)
        write(nll, "nll")
        if isinstance(prediction, Bernoulli):
            write(calculate_acc(prediction.probs, data.y), "acc")
            write(calculate_auc(prediction.probs, data.y), "auc")
            write(calculate_f1(prediction.probs, data.y), "f1")
        if isinstance(model, ConformaliseBase):
            write(calculate_median_interval_width(model=model, x=data.x, coverage=coverage),
                  "median_interval_width")
            write(calculate_average_interval_width(model=model, x=data.x, coverage=coverage),
                  "average_interval_width")


def concatenate_metrics(
    results_path: str,
    data_types: list[str],
    model_names: list[str],
    datasets: list[str],
    metrics: list[str],
) -> None:
    """Join the per-dataset CSVs into one table per metric and split: a row
    per dataset, a column per model. A dataset with any model's file missing
    is reported and left out, and a table with no dataset is not written."""
    for data_type in data_types:
        for metric in metrics:
            rows = []
            for dataset in datasets:
                try:
                    values = []
                    for model in model_names:
                        path = os.path.join(results_path, dataset, model,
                                            f"{metric}_{data_type}.csv")
                        _, table = _read_table(path)
                        values.extend(table[0][1])
                    rows.append((dataset, values))
                except (OSError, ValueError, IndexError) as e:
                    print(e)
                    print(f"Dataset {dataset} failed to load results.")
            if rows:
                _write_table(os.path.join(results_path, f"{metric}_{data_type}.csv"),
                             model_names, rows)


def concatenate_seed(outputs_path: str, seed: int, dataset_names: list[str],
                     model_names: list[str], metrics: list[str]) -> None:
    """A seed's tables over every dataset with results on disk, not only
    the run's: a one-dataset gap-fill run must not overwrite the seed's
    tables with a one-dataset table."""
    results_root = os.path.join(outputs_path, str(seed), "results")
    present = (
        [d for d in os.listdir(results_root) if os.path.isdir(os.path.join(results_root, d))]
        if os.path.isdir(results_root)
        else []
    )
    concatenate_metrics(
        results_path=results_root,
        data_types=["train", "test"],
        model_names=model_names,
        datasets=sorted(set(dataset_names) | set(present)),
        metrics=metrics,
    )
