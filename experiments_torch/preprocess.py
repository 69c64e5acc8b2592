"""Data splitting and normalisation (counterpart of ``experiments/preprocess.py``).

The splits are computed in numpy fp64 on the host, so they are the JAX
harness's bit for bit, and only then become tensors on the caller's device.
:func:`train_test_split` rebuilds scikit-learn's shuffled
``train_test_split(..., random_state=seed)``, which the JAX harness calls:
``RandomState(seed).permutation(n)``, the first ``ceil(test_size n)`` rows
to the test split, the rest to the train split in permutation order.

``split_regression_data_intervals`` holds out contiguous intervals of a 1-D
curve: randomly drawn interior intervals plus the two first and the two last
intervals always go to the test split (interpolation and edge
extrapolation).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from experiments_torch.data import Data, ExperimentData, ProblemType
from projected_langevin_sampling_torch.utils.device import as_tensor


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def train_test_split(x: np.ndarray, y: np.ndarray, test_size: float, random_state: int):
    """``(x_train, x_test, y_train, y_test)`` as scikit-learn's shuffled
    split with a float ``test_size`` in (0, 1)."""
    n = x.shape[0]
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size}, the train set is empty")
    permutation = np.random.RandomState(random_state).permutation(n)
    test, train = permutation[:n_test], permutation[n_test:]
    return x[train], x[test], y[train], y[test]


def split_regression_data_intervals(
    split_seed: int,
    x,
    y,
    number_of_test_intervals: int,
    total_number_of_intervals: int,
    y_untransformed=None,
):
    """Returns (x_train, y_train, y_train_untransformed, x_test, y_test,
    y_test_untransformed) as tensors on the device of ``x`` (the card if
    ``x`` is not a tensor)."""
    device = x.device if isinstance(x, torch.Tensor) else None
    x_np, y_np = _host(x), _host(y)
    yu_np = None if y_untransformed is None else _host(y_untransformed)

    n = x_np.shape[0]
    interval_size = n // total_number_of_intervals
    edge = max(int(total_number_of_intervals / 8), 3)
    rng = np.random.default_rng(split_seed)
    interior = rng.permutation(total_number_of_intervals - 2 * edge)[
        :number_of_test_intervals
    ] + edge
    excluded = set(interior.tolist()) | {
        0,
        1,
        total_number_of_intervals - 2,
        total_number_of_intervals - 1,
    }

    def gather(arr, intervals):
        return np.concatenate(
            [arr[interval_size * i : interval_size * (i + 1)] for i in intervals]
        )

    train_intervals = [i for i in range(total_number_of_intervals) if i not in excluded]
    test_intervals = [i for i in range(total_number_of_intervals) if i in excluded]
    out = (
        gather(x_np, train_intervals),
        gather(y_np, train_intervals),
        None if yu_np is None else gather(yu_np, train_intervals),
        gather(x_np, test_intervals),
        gather(y_np, test_intervals),
        None if yu_np is None else gather(yu_np, test_intervals),
    )
    return tuple(None if a is None else as_tensor(a, device=device) for a in out)


def split_regression_data(
    seed: int,
    x,
    y,
    train_data_percentage: float,
    validation_data_percentage: float,
    test_data_percentage: float,
):
    """The two-stage split; returns (x_train, y_train, x_test, y_test,
    x_validation, y_validation) as tensors on the device of ``x`` (the card
    if ``x`` is not a tensor)."""
    device = x.device if isinstance(x, torch.Tensor) else None
    x_train, x_rest, y_train, y_rest = train_test_split(
        _host(x), _host(y), test_size=1 - train_data_percentage, random_state=seed,
    )
    x_validation, x_test, y_validation, y_test = train_test_split(
        x_rest, y_rest,
        test_size=test_data_percentage / (test_data_percentage + validation_data_percentage),
        random_state=seed,
    )
    return tuple(
        as_tensor(a, device=device)
        for a in (x_train, y_train, x_test, y_test, x_validation, y_validation)
    )


def set_up_experiment(
    name: str,
    problem_type: ProblemType,
    seed: int,
    x,
    y,
    train_data_percentage: float,
    normalise: bool = True,
    validation_data_percentage: float = 0.0,
    device=None,
    dtype: torch.dtype | None = None,
) -> ExperimentData:
    """Split and normalise y on the training split, in numpy fp64; the data
    become tensors on ``device`` (the card unless the caller asks for the
    CPU) in ``dtype`` (default: the input's)."""
    x_np, y_np = _host(x), _host(y)
    x_train, x_test, y_train, y_test = train_test_split(
        x_np, y_np,
        test_size=1 - (train_data_percentage + validation_data_percentage),
        random_state=seed,
    )
    if validation_data_percentage > 0:
        x_train, x_validation, y_train, y_validation = train_test_split(
            x_train, y_train,
            test_size=validation_data_percentage
            / (validation_data_percentage + train_data_percentage),
            random_state=seed,
        )
    else:
        x_validation, y_validation = None, None

    if normalise:
        y_mean = float(np.mean(y_train))
        y_std = float(np.std(y_train, ddof=1))
        y_np = (y_np - y_mean) / y_std
        y_train = (y_train - y_mean) / y_std
        y_test = (y_test - y_mean) / y_std
        if y_validation is not None:
            y_validation = (y_validation - y_mean) / y_std
    else:
        y_mean, y_std = 0.0, 1.0

    def data(x_part, y_part, part):
        return Data(x=as_tensor(x_part, device=device, dtype=dtype),
                    y=as_tensor(y_part, device=device, dtype=dtype), name=part)

    return ExperimentData(
        name=name,
        problem_type=problem_type,
        full=data(x_np, y_np, "full"),
        train=data(x_train, y_train, "train"),
        validation=(
            data(x_validation, y_validation, "validation")
            if validation_data_percentage > 0
            else None
        ),
        test=data(x_test, y_test, "test"),
        y_mean=y_mean,
        y_std=y_std,
    )
