"""Binary classification on real data (UCI WDBC) with the headline PLS
classification recipe, on the PyTorch port: the twin of
``examples/classification_demo.py``, in fp64.

  greedy conditional-variance inducing points (m = 64)
  + the nystrom-scaled ONB ("consistent KKL")
  + the residual-smoothed Bernoulli cost (FITC-style expected log-likelihood)
  + the empirical-Bayes MAP prior-mean constant
  + Lambda-preconditioned Langevin, 3000 steps, J = 100.

The data are ``examples/data/wdbc.csv``, a copy of the WDBC table that
scikit-learn bundles for ``load_breast_cancer`` (Wolberg, Street and
Mangasarian, UCI Machine Learning Repository, CC BY 4.0): a header line, then
569 rows of 30 features and the target (0 malignant, 1 benign). The split is
scikit-learn's ``train_test_split(test_size=0.2, random_state=0)``, which the
JAX demo uses, as the UCI harness rebuilds it with numpy
(``experiments_torch.preprocess.train_test_split``), so the demo needs no
scikit-learn.

Run: python examples/classification_demo_torch.py [--device cpu]   (default: cuda)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import projected_langevin_sampling_torch as pt  # noqa: E402
from experiments_torch.preprocess import train_test_split  # noqa: E402
from projected_langevin_sampling_torch.models.link_functions import SigmoidLinkFunction  # noqa: E402


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "wdbc.csv")


def load_wdbc():
    """(features (569, 30), target (569,)) of the bundled WDBC table."""
    table = np.loadtxt(DATA, delimiter=",", skiprows=1)
    return table[:, :-1], table[:, -1]


def main(device=None) -> float:
    """Run the demo on ``device`` (the card unless "cpu"); returns the test
    accuracy."""
    device = torch.device("cuda" if device is None else device)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)  # noqa: E731

    # 1. real data: Wisconsin Diagnostic Breast Cancer (569 x 30), standardised
    features, target = load_wdbc()
    x_all = (features - features.mean(0)) / features.std(0)
    x_train, x_test, y_train, y_test = (
        f64(a) for a in train_test_split(x_all, target, test_size=0.2, random_state=0))

    # 2. kernel + greedy inducing points + nystrom-scaled ONB basis
    kernel = pt.ARDKernel(lengthscales=f64(np.full(x_train.shape[1], 3.0)), outputscale=f64(1.0))
    z, _ = pt.ConditionalVarianceInducingPointSelector()(
        x_train, m=64, kernel=kernel, rng=np.random.default_rng(0)
    )
    basis = pt.build_orthonormal_basis(
        pt.PLSKernel(base_kernel=kernel, approximation_samples=x_train), z, x_train,
        scaling="nystrom", relative_eigenvalue_threshold=1e-6, verbose=False,
    )

    # 3. residual-smoothed Bernoulli cost (FITC-style expected log-likelihood)
    smoothing_std = pt.residual_smoothing_std(basis, kernel(x_train, diag=True))
    cost = pt.make_smoothed_bernoulli_cost(y_train=y_train, smoothing_std=smoothing_std)

    # 4. empirical-Bayes MAP prior-mean constant
    m0 = pt.fit_mean_constant_map(basis=basis, cost=cost)
    basis = basis.replace(mean_constant=m0)
    print(f"MAP prior-mean constant: {float(m0):.4f}")

    # 5. Langevin with the Lambda-preconditioned discretisation
    pls = pt.PLS(basis=basis, cost=cost)
    particles = pls.initialise_particles(100, generator=0)
    particles, energies = pt.train_pls(
        pls, particles, number_of_epochs=3000, step_size=1e-3, generator=1,
        discretisation="preconditioned",
    )
    print(f"energy: {energies[0]:.1f} -> {energies[-1]:.1f}")

    # 6. predictive probabilities = mean sigmoid over the particle cloud
    probs = torch.mean(
        SigmoidLinkFunction()(pls.predict_untransformed_samples(particles=particles, x=x_test)),
        dim=1,
    )
    acc = float(torch.mean(((probs > 0.5) == (y_test > 0.5)).to(torch.float64)))
    eps = 1e-12
    nll = float(-torch.mean(y_test * torch.log(probs + eps)
                            + (1 - y_test) * torch.log(1 - probs + eps)))
    print(f"test accuracy: {acc:.4f}  test NLL: {nll:.4f}  (n_test={len(y_test)})")
    return acc


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu to run off the card")
    accuracy = main(parser.parse_args().device)
    assert accuracy > 0.9, "expected >90% accuracy on WDBC"
    print("CLASSIFICATION DEMO OK")
