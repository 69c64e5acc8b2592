"""The benchmark's inputs, made on the device from ``--seed``.

A frozen copy of the synthetic UCI generator that the port's harness and its
card script use (``experiments_torch/uci/make_synthetic_datasets.py``, its
``make_dataset``; ``kin8nm_like`` beside it): correlated Gaussian inputs, a
latent sum of 8 RBF bumps of lengthscale sqrt(D), regression targets that
latent plus noise at a tenth of its spread, classification labels from a
logistic model of it. Here the draws come from a ``torch.Generator`` on the
run's device in a few large calls, not from numpy on the host, so a seed
gives the same inputs on every run on one kind of device.

The split is the UCI mains' (``experiments_torch/preprocess.py``): a test
share of ceil(0.1 N) rows, then a validation share of the rest, so 8192 rows
leave 6552 for training and 3810 leave 3048. Inputs are standardised on the
training rows; regression targets too (ddof 1, as the mains).

Kernel hyperparameters, the inducing points and every call's starting state
are drawn from the seed too: the mains fit them in stages that are not timed.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int below 2**63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def split_sizes(rows: int, train_fraction: float, validation_fraction: float):
    """(train, validation, test) row counts of the mains' two shuffled splits."""
    n_test = math.ceil((1.0 - train_fraction - validation_fraction) * rows)
    rest = rows - n_test
    n_validation = math.ceil(validation_fraction / (validation_fraction + train_fraction) * rest)
    return rest - n_validation, n_validation, n_test


def make_dataset(config: dict, gen: torch.Generator, dtype, device):
    """``(x_train, y_train)`` of the configuration's synthetic data set."""
    rows, d = int(config["rows"]), int(config["inputs"])
    normal = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype, device=device)  # noqa: E731
    mixing = normal(d, d) / math.sqrt(d)
    x = normal(rows, d) @ mixing
    centres, weights = normal(8, d), 2.0 * normal(8)
    d2 = torch.square((x[:, None, :] - centres[None, :, :]) / math.sqrt(d)).sum(-1)
    f = torch.exp(-0.5 * d2) @ weights
    if config["task"] == "classification":
        p = torch.sigmoid(3.0 * (f - torch.median(f)))
        y = (torch.rand(rows, generator=gen, dtype=dtype, device=device) < p).to(dtype)
    else:
        y = f + 0.1 * torch.std(f, correction=0) * normal(rows)
    n_train, _, _ = split_sizes(rows, config["train_fraction"], config["validation_fraction"])
    train = torch.randperm(rows, generator=gen, device=device)[:n_train]
    x, y = x[train], y[train]
    x = (x - x.mean(0)) / x.std(0, correction=0)
    if config["task"] != "classification":
        y = (y - y.mean()) / y.std(correction=1)
    return x.contiguous(), y.contiguous()


def number_of_inducing_points(config: dict, n_train: int) -> int:
    """The mains' rule, int(factor * N^(1 / power))."""
    return int(config["inducing_points_factor"] * math.pow(n_train, 1.0 / config["inducing_points_power"]))


def uniform(gen: torch.Generator, bounds, shape=(), dtype=torch.float64, device="cpu", log=False):
    """Draws uniform in ``bounds`` (log-uniform with ``log``)."""
    lo, hi = (math.log(b) for b in bounds) if log else bounds
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    v = lo + (hi - lo) * u
    return torch.exp(v) if log else v


def kernel_hyperparameters(config: dict, gen: torch.Generator, dtype, device) -> dict:
    """The ARD kernel, noise and prior mean constant, drawn in the ranges the
    configuration states: ``lengthscales`` (D,), ``outputscale``, ``noise``,
    ``mean_constant`` as 0-d tensors."""
    h = config["hyperparameters"]
    d = int(config["inputs"])
    return {
        "lengthscales": uniform(gen, h["lengthscale"], (d,), dtype, device, log=True),
        "outputscale": uniform(gen, h["outputscale"], (), dtype, device, log=True),
        "noise": uniform(gen, h["noise"], (), dtype, device, log=True),
        "mean_constant": uniform(gen, h["mean_constant"], (), dtype, device),
    }


def inducing_indices(n_train: int, m: int, gen: torch.Generator, device) -> torch.Tensor:
    """``m`` distinct training rows drawn uniformly (the mains select them
    by conditional variance, a stage before any timed call)."""
    return torch.randperm(n_train, generator=gen, device=device)[:m]


def nearest_rows(x: torch.Tensor, size: int, gen: torch.Generator) -> torch.Tensor:
    """The ``size`` rows nearest a random row, nearest first: the exact-GP
    subsample of the mains (``experiments_torch/runners.py``,
    ``subsample_data_indices``)."""
    centre = x[torch.randint(0, x.shape[0], (1,), generator=gen, device=x.device)]
    d2 = torch.square(x - centre).sum(-1)
    return torch.sort(d2, stable=True).indices[:size]
