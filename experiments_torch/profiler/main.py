"""Profiler sweeps of PLS against SVGP training (counterpart of
``experiments/profiler/main.py``): N (data points), M (inducing points), T
(epochs) and J (particles) swept one axis at a time, the others at their
defaults, over seeds, in fp32; one CSV per axis with the columns
``axis,value,seed,model,wall_time_milliseconds`` and no plots.

Each PLS row times ``training._train_pls_loop``, the port's counterpart of
the JAX ``_train_pls_scan``, at the tier ``fast_path`` resolves to (the
spectral tier, on B1, for "auto"), with infinite patience and the drift's
factorisation inside the timed call, as in the JAX program. Each SVGP row
times ``fit_svgp``, full batch, with the kernel and noise frozen. Both step
sizes are 1e-10, so the numbers measure compute, not dynamics. A warm-up
call comes first (the first use of a kernel builds it with nvcc, and the
first call of a library makes its handles), and each timed call ends with
a device synchronisation before the host clock is read.

    python -m experiments_torch.profiler.main --config_path experiments/profiler/config.yaml
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from experiments_torch.config import load_config
from experiments_torch.curves.curves import Curve2
from experiments_torch.utils import create_directory
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import GaussianCost
from projected_langevin_sampling_torch.models.gaussian_process import (
    GaussianLikelihood,
    init_svgp,
)
from projected_langevin_sampling_torch.models.gaussian_process.training import fit_svgp
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_torch.training import _train_pls_loop, resolve_tier
from projected_langevin_sampling_torch.utils.device import resolve_device

COLUMNS = ["axis", "value", "seed", "model", "wall_time_milliseconds"]
AXES = {"number_of_data_points": "n", "number_of_induce_points": "m",
        "number_of_epochs": "t", "number_of_particles": "j"}


def _make_problem(n: int, m: int, seed: int, device=None, dtype=torch.float32, y=None):
    """Sorted uniform inputs on [-3, 3] from numpy's ``default_rng(seed)``,
    Curve2's noisy values (a host draw from ``seed``, or ``y``), a unit ARD
    kernel and an ONB on m evenly spaced inducing points, on ``device``.
    Returns (basis, cost, kernel, z)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(np.sort(rng.uniform(-3, 3, (n, 1)), axis=0), dtype=dtype)
    if y is None:
        y = Curve2().regression(x=x, sigma_true=0.2, generator=seed)
    x, y = x.to(device), torch.as_tensor(y, dtype=dtype).to(device)
    kernel = PLSKernel(
        base_kernel=ARDKernel(lengthscales=torch.ones(1, dtype=dtype, device=device),
                              outputscale=torch.tensor(1.0, dtype=dtype, device=device)),
        approximation_samples=x,
    )
    z = torch.as_tensor(np.linspace(-3, 3, m)[:, None], dtype=dtype, device=device)
    basis = build_orthonormal_basis(kernel, z, x, verbose=False)
    cost = GaussianCost(y_train=y, observation_noise=torch.tensor(1.0, dtype=dtype, device=device))
    return basis, cost, kernel, z


def _synchronise(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_pls(n, m, t, j, seed, fast_path, device=None, step_size=1e-10) -> tuple[float, str]:
    """(milliseconds of PLS training, the tier it ran)."""
    basis, cost, _, _ = _make_problem(n, m, seed, device)
    particles = basis.initialise_particles(j, generator=seed)
    tier = resolve_tier(basis, cost, fast_path, "euler")

    def run():
        return _train_pls_loop(basis, cost, particles, step_size, float("inf"), t, tier,
                               generator=seed).particles

    run()  # warm-up: the first use builds the kernel and the library handles
    _synchronise(basis.device)
    start = time.perf_counter()
    run()
    _synchronise(basis.device)
    return (time.perf_counter() - start) * 1e3, tier


def profile_svgp(n, m, t, seed, device=None, learning_rate=1e-10) -> float:
    """Milliseconds of SVGP training: full-batch SGD on the ELBO with the
    kernel and noise frozen."""
    _, cost, kernel, z = _make_problem(n, m, seed, device)
    svgp = init_svgp(0.0, kernel,
                     GaussianLikelihood(noise=torch.tensor(1.0, dtype=z.dtype, device=z.device)), z)
    x, y = kernel.approximation_samples, cost.y_train

    def run(epochs):
        fit_svgp(svgp, x, y, number_of_epochs=epochs, batch_size=n, learning_rate=learning_rate,
                 learn_kernel_parameters=False, learn_observation_noise=False, generator=seed)

    run(1)  # warm-up
    _synchronise(z.device)
    start = time.perf_counter()
    run(t)
    _synchronise(z.device)
    return (time.perf_counter() - start) * 1e3


def _sweep_values(cfg: dict) -> list[int]:
    return list(range(cfg["start"], cfg["stop"] + 1, cfg["step"]))


def write_sweep(path: str, rows: list[list]) -> None:
    """One axis's rows in the JAX profiler's CSV layout (pandas', no index)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        for axis, value, seed, model, ms in rows:
            writer.writerow([axis, value, seed, model, repr(float(ms))])


def run_sweeps(config: dict, outputs_path: str, fast_path: str = "auto", device=None) -> dict:
    """Every axis's sweep; writes ``<axis>.csv`` under ``outputs_path`` and
    returns {axis: its rows}. Each PLS row's tier is printed."""
    defaults = {param: config[axis]["default"] for axis, param in AXES.items()}
    seeds = range(config["profiler"]["number_of_seeds"])
    create_directory(outputs_path)
    sweeps = {}
    for axis, param in AXES.items():
        rows = []
        for value in _sweep_values(config[axis]):
            args = dict(defaults, **{param: value})
            for seed in seeds:
                pls_ms, tier = profile_pls(args["n"], args["m"], args["t"], args["j"], seed,
                                           fast_path, device)
                rows.append([axis, value, seed, "pls", pls_ms])
                line = f"pls {pls_ms:.3f} ms ({tier} tier)"
                if param != "j":  # SVGP has no particle axis
                    svgp_ms = profile_svgp(args["n"], args["m"], args["t"], seed, device)
                    rows.append([axis, value, seed, "svgp", svgp_ms])
                    line += f", svgp {svgp_ms:.3f} ms"
                print(f"{axis}={value} seed={seed}: {line}", flush=True)
        write_sweep(os.path.join(outputs_path, f"{axis}.csv"), rows)
        sweeps[axis] = rows
    return sweeps


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profiler sweeps for PLS vs SVGP.")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--fast_path", type=str, default="auto",
                   choices=["auto", "spectral", "quadratic", "off"])
    p.add_argument("--outputs_dirname", type=str, default="outputs")
    p.add_argument("--device", type=str, default="cuda")
    return p


def cli(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    config = load_config(args.config_path)
    outputs_path = os.path.join(os.path.dirname(os.path.realpath(__file__)), args.outputs_dirname)
    run_sweeps(config, outputs_path, args.fast_path, args.device)


if __name__ == "__main__":
    cli()
