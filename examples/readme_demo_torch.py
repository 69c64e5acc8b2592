"""The README 1-D sin regression walkthrough on the PyTorch port: data ->
greedy inducing points -> ONB basis + Gaussian cost -> Langevin training
(the spectral tier: the hand-written kernel on the card) -> tempering. The
twin of ``examples/readme_demo.py``, in fp64, without the figures.

Run: python examples/readme_demo_torch.py [--device cpu]   (default: cuda)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import projected_langevin_sampling_torch as pt  # noqa: E402


def main(device=None) -> float:
    """Run the demo on ``device`` (the card unless "cpu"); returns the RMSE
    of the tempered mean against the true sin."""
    device = torch.device("cuda" if device is None else device)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)  # noqa: E731

    # 1. data: noisy sin, deliberately with a misspecified noise variance later
    number_of_points, observation_noise = 100, 0.1
    x = f64(np.linspace(-1, 1, number_of_points).reshape(-1, 1))
    noise = np.random.default_rng(0).normal(size=number_of_points)
    y = torch.sin(2 * np.pi * x[:, 0]) + observation_noise * f64(noise)

    # 2. greedy inducing-point selection (conditional variance)
    kernel = pt.ARDKernel(lengthscales=f64([0.1]), outputscale=f64(1.0))
    x_induce, _ = pt.ConditionalVarianceInducingPointSelector()(
        x, m=int(np.sqrt(number_of_points)), kernel=kernel, rng=np.random.default_rng(0)
    )

    # 3. ONB basis + Gaussian cost, observation noise misspecified at 0.5
    basis = pt.build_orthonormal_basis(
        pt.PLSKernel(base_kernel=kernel, approximation_samples=x), x_induce, x
    )
    cost = pt.GaussianCost(y_train=y, observation_noise=f64(0.5))
    pls = pt.PLS(basis=basis, cost=cost)
    particles = pls.initialise_particles(100, generator=0)

    # 4. the Langevin gradient flow
    particles, energies = pt.train_pls(
        pls, particles, number_of_epochs=2000, step_size=1e-3, early_stopper_patience=1.0,
        generator=1, fast_path="spectral",
    )
    print(f"energy potential: {energies[0]:.2f} -> {energies[-1]:.2f}")

    # 5. tempering on held-out data from the same distribution
    x_cal = f64(np.linspace(-1, 1, 50).reshape(-1, 1))
    y_cal = torch.sin(2 * np.pi * x_cal[:, 0]) + observation_noise * f64(
        np.random.default_rng(7).normal(size=50)
    )
    tempered = pt.TemperPLS(x_calibration=x_cal, y_calibration=y_cal, pls=pls,
                            particles=particles, generator=2)
    prediction = tempered(x)
    truth = torch.sin(2 * np.pi * x[:, 0])
    rmse = float(torch.sqrt(torch.mean((prediction.mean - truth) ** 2)))
    print(f"tempered scale: {tempered.scale:.3f} (misspecified noise corrected)")
    print(f"RMSE vs true sin: {rmse:.3f}")
    return rmse


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu to run off the card")
    rmse = main(parser.parse_args().device)
    # the misspecified noise shrinks the posterior mean; tempering still
    # calibrates the predictive variance
    assert rmse < 0.35, "demo did not converge"
    print("README DEMO OK")
