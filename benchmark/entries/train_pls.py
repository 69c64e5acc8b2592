"""Calls of ``train_pls`` back to back, as the UCI mains' step-size search
makes them: the configuration's ONB model (its basis, cost and MAP mean
constant built once in set-up), each call from fresh noise-only particles
drawn from the seed, one candidate of the mains' step grid for
simulation_duration / eta steps with infinite patience, ``fast_path`` and
``discretisation`` as the configuration states, the Langevin noise from a
generator seeded per call."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import data
from benchmark.harness.compare import leaf_gap, trace_gap
from benchmark.reference import pls as reference

END_TO_END = "updates_per_s"


def end_to_end(window_s: float, work: float) -> float:
    return work / window_s


def step_grid(pls: dict) -> np.ndarray:
    """The mains' log-spaced step sizes (``experiments_torch/runners.py``,
    ``train_pls_runner``)."""
    return np.logspace(np.log10(pls["step_size_upper"]),
                       np.log10(pls["simulation_duration"] / pls["maximum_number_of_steps"]),
                       pls["number_of_step_searches"])


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from projected_langevin_sampling_torch.models.basis.orthonormal import (
            build_orthonormal_basis,
        )
        from projected_langevin_sampling_torch.models.costs import GaussianCost
        from projected_langevin_sampling_torch.models.costs.smoothed_bernoulli import (
            make_smoothed_bernoulli_cost,
            residual_smoothing_std,
        )
        from projected_langevin_sampling_torch.models.link_functions import IdentityLinkFunction
        from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map
        from projected_langevin_sampling_torch.models.pls import PLS
        from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
        from projected_langevin_sampling_torch.training import train_pls

        self._train = train_pls
        self.config, self.traffic, self.device = config, traffic, device
        self.dtype = dtype or getattr(torch, config["dtype"])
        pls = config["pls"]
        gen = data.generator(seed, device)
        self.x, self.y = data.make_dataset(config, gen, self.dtype, device)
        self.kernel = data.kernel_hyperparameters(config, gen, self.dtype, device)
        m = data.number_of_inducing_points(config, self.x.shape[0])
        self.z = self.x[data.inducing_indices(self.x.shape[0], m, gen, device)]
        ard = ARDKernel(self.kernel["lengthscales"], self.kernel["outputscale"])
        basis = build_orthonormal_basis(
            PLSKernel(ard, self.z), self.z, self.x, scaling=pls["onb_scaling"],
            relative_eigenvalue_threshold=pls["onb_relative_eigenvalue_threshold"], verbose=False)
        if pls["cost"] == "gaussian":
            cost = GaussianCost(observation_noise=self.kernel["noise"], y_train=self.y,
                                link_function=IdentityLinkFunction())
        else:
            cost = make_smoothed_bernoulli_cost(
                y_train=self.y, smoothing_std=residual_smoothing_std(basis, ard(self.x, diag=True)),
                number_of_quadrature_nodes=pls["quadrature_nodes"])
        if pls["mean_constant"] == "map":
            basis = basis.replace(mean_constant=fit_mean_constant_map(basis=basis, cost=cost))
        self.pls = PLS(basis=basis, cost=cost)
        self.m_k = basis.approximation_dimension
        self.j = int(pls["number_of_particles"])
        self.eta = float(step_grid(pls)[int(traffic["step_index"])])
        self.steps = int(pls["simulation_duration"] / self.eta)
        # one extra start for the warm-up call, after the pool
        self.pool = [
            {"particles": torch.randn((self.m_k, self.j), generator=gen, dtype=self.dtype, device=device),
             "seed": int(torch.randint(0, 2**62, (1,), generator=gen, device=device))}
            for _ in range(int(traffic["pool"]) + 1)
        ]
        self.answers: dict[int, dict] = {}

    @property
    def shapes(self) -> dict:
        pls = self.config["pls"]
        return {"n": self.x.shape[0], "m_k": self.m_k, "j": self.j, "steps": self.steps,
                "cost": pls["cost"], "quadrature_nodes": pls.get("quadrature_nodes", 0)}

    def _start(self, i: int) -> dict:
        return self.pool[i % (len(self.pool) - 1)] if i >= 0 else self.pool[-1]

    def call(self, i: int) -> float:
        """Run ``i`` of the window (-1: the warm-up); returns the particle
        updates it completed (J times its steps)."""
        start = self._start(i)
        pls = self.config["pls"]
        particles, energies = self._train(
            self.pls, start["particles"], number_of_epochs=self.steps, step_size=self.eta,
            early_stopper_patience=math.inf,
            generator=torch.Generator(device=self.device).manual_seed(start["seed"]),
            fast_path=pls["fast_path"], discretisation=pls["discretisation"])
        self.answers[i] = {"particles": particles.detach().clone(), "energies": energies}
        return float(self.j * len(energies))

    def release(self) -> None:
        self.pls = self._train = None

    def reference(self, i: int, dtype=None) -> dict:
        dtype = dtype or self.dtype
        start = self._start(i)
        model = reference.make_model(self.x, self.y, self.z, self.kernel, self.config["pls"], dtype)
        if model.lam.shape[0] != self.m_k:
            raise ValueError(f"the reference keeps {model.lam.shape[0]} eigenpairs, the program {self.m_k}")
        u, energies = reference.train(
            model, start["particles"], self.eta, self.steps,
            torch.Generator(device=self.device).manual_seed(start["seed"]))
        return {"particles": u, "energies": energies}

    def compare(self, i: int, answer: dict | None, truth: dict) -> dict:
        if answer is None:
            return {"particles_gap": math.inf, "energy_gap": math.inf}
        start = {"particles": self._start(i)["particles"]}
        return {"particles_gap": leaf_gap({"particles": answer["particles"]},
                                          {"particles": truth["particles"]}, start),
                "energy_gap": trace_gap(answer["energies"], truth["energies"])}
