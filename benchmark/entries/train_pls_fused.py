"""Calls of ``train_pls`` on the ``general_fused`` tier back to back, as the
library's own usage example makes them (README: ``fast_path="general_fused"``,
``discretisation="preconditioned"``): the configuration's ONB model (its
basis, residual-smoothed cost and MAP mean constant built once in set-up),
each call from fresh noise-only particles drawn from the seed, ``steps``
steps of the protocol's ``step_size_upper`` with infinite patience, and a
generator seeded per call, from which ``train_pls`` draws the kernel's
Philox seed. The kernel draws its normals itself, so the reference rebuilds
them from that seed (``reference/pls_philox.py``)."""

from __future__ import annotations

import math

import torch

from benchmark.harness import data
from benchmark.harness.compare import leaf_gap
from benchmark.reference import pls as reference
from benchmark.reference import pls_philox

END_TO_END = "updates_per_s"


def end_to_end(window_s: float, work: float) -> float:
    return work / window_s


def make_inputs(config: dict, gen: torch.Generator, dtype, device):
    """``(x, y, z)``: sorted uniform inputs on ``x_range``, labels
    1[sin 2x + label_noise eps > 0] and evenly spaced inducing points."""
    lo, hi = config["x_range"]
    rows = int(config["rows"])
    x = torch.sort(lo + (hi - lo) * torch.rand(rows, generator=gen, dtype=dtype, device=device))
    x = x.values[:, None].contiguous()
    eps = torch.randn(rows, generator=gen, dtype=dtype, device=device)
    y = (torch.sin(2.0 * x[:, 0]) + config["label_noise"] * eps > 0).to(dtype)
    z = torch.linspace(lo, hi, int(config["inducing_points"]), dtype=dtype, device=device)[:, None]
    return x, y, z


def step_gap(program: list[float], reference: list[float]) -> float:
    """The widest gap of two energy traces, each step's over the reference's
    magnitude at that step; a trace of another length reads inf.

    Held to each step's own magnitude, the late steps count as much as the
    first, where a gap over the trace's largest magnitude sees only the
    first: the energy falls from about 3e5 (the prior term of noise-only
    particles) to about 6e3. The energy is a mean over the J particles, so
    the state's fp32 rounding, independent between particles, weighs less
    in it than in the particles' largest element gap."""
    if len(program) != len(reference) or not reference:
        return math.inf
    gaps = [abs(a - b) / abs(b) if b else math.inf for a, b in zip(program, reference)]
    return math.inf if any(g != g for g in gaps) else max(gaps)


def general_steps() -> int | None:
    """The steps the general-cost kernel has queued in this process, where
    the program counts them."""
    from projected_langevin_sampling_torch.ops.cuda import general_train

    return getattr(general_train.general_train, "steps", None)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from projected_langevin_sampling_torch.models.basis.orthonormal import (
            build_orthonormal_basis,
        )
        from projected_langevin_sampling_torch.models.costs.smoothed_bernoulli import (
            make_smoothed_bernoulli_cost,
            residual_smoothing_std,
        )
        from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map
        from projected_langevin_sampling_torch.models.pls import PLS
        from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
        from projected_langevin_sampling_torch.training import train_pls

        self._train = train_pls
        self.config, self.traffic, self.device = config, traffic, device
        self.dtype = dtype or getattr(torch, config["dtype"])
        pls = config["pls"]
        gen = data.generator(seed, device)
        self.x, self.y, self.z = make_inputs(config, gen, self.dtype, device)
        as_t = lambda v: torch.as_tensor(v, dtype=self.dtype, device=device)  # noqa: E731
        self.kernel = {"lengthscales": as_t([config["kernel"]["lengthscale"]]),
                       "outputscale": as_t(config["kernel"]["outputscale"])}
        # the model is built in build_dtype from the inputs and rounded to the
        # training dtype (PERF.md, section 4: an fp32 build of this basis
        # keeps no digit of P)
        build = getattr(torch, config["build_dtype"])
        x_b, z_b = self.x.to(build), self.z.to(build)
        ard = ARDKernel(self.kernel["lengthscales"].to(build), self.kernel["outputscale"].to(build))
        basis = build_orthonormal_basis(
            PLSKernel(ard, z_b), z_b, x_b, scaling=pls["onb_scaling"],
            relative_eigenvalue_threshold=pls["onb_relative_eigenvalue_threshold"], verbose=False)
        if basis.approximation_dimension != int(config["inducing_points"]):
            raise ValueError(f"M_k = {basis.approximation_dimension}, not the "
                             f"{config['inducing_points']} inducing points")
        smoothing = residual_smoothing_std(basis, ard(x_b, diag=True))
        cost = make_smoothed_bernoulli_cost(y_train=self.y.to(build), smoothing_std=smoothing,
                                            number_of_quadrature_nodes=pls["quadrature_nodes"])
        m0 = fit_mean_constant_map(basis=basis, cost=cost)
        cast = lambda t: t.to(self.dtype)  # noqa: E731
        basis = basis.replace(
            kernel=PLSKernel(ARDKernel(self.kernel["lengthscales"], self.kernel["outputscale"]),
                             self.z),
            x_induce=self.z, eigenvalues=cast(basis.eigenvalues),
            scaled_eigenvectors=cast(basis.scaled_eigenvectors),
            base_gram_induce_train=cast(basis.base_gram_induce_train),
            train_projection=cast(basis.train_projection), mean_constant=m0)
        cost = make_smoothed_bernoulli_cost(y_train=self.y, smoothing_std=cast(smoothing),
                                            number_of_quadrature_nodes=pls["quadrature_nodes"])
        self.pls = PLS(basis=basis, cost=cost)
        self.m_k = basis.approximation_dimension
        self.j = int(pls["number_of_particles"])
        self.eta = float(pls["step_size_upper"])
        self.steps = int(traffic["steps"])
        # one extra start for the warm-up call, after the pool
        self.pool = [
            {"particles": torch.randn((self.m_k, self.j), generator=gen, dtype=self.dtype,
                                      device=device),
             "seed": int(torch.randint(0, 2**62, (1,), generator=gen, device=device))}
            for _ in range(int(traffic["pool"]) + 1)
        ]
        self.answers: dict[int, dict] = {}
        self._steps_before = None
        self._model = None

    @property
    def shapes(self) -> dict:
        now = general_steps()
        queued = None if now is None or self._steps_before is None else now - self._steps_before
        return {"n": self.x.shape[0], "m_k": self.m_k, "j": self.j, "steps": self.steps,
                "quadrature_nodes": self.config["pls"]["quadrature_nodes"],
                "general_train_steps": queued}

    def _start(self, i: int) -> dict:
        return self.pool[i % (len(self.pool) - 1)] if i >= 0 else self.pool[-1]

    def philox_seed(self, i: int) -> int:
        """The kernel's seed of call ``i``, as ``train_pls`` draws it."""
        return pls_philox.philox_seed(self._start(i)["seed"], self.device)

    def call(self, i: int) -> float:
        """Run ``i`` of the window (-1: the warm-up); returns the particle
        updates it completed (J times its steps)."""
        if i == 0:
            self._steps_before = general_steps()
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

    def model(self) -> reference.Model:
        """The reference's basis, cost and MAP mean constant, in fp64 from the
        raw inputs."""
        if self._model is None:
            self._model = reference.make_model(self.x, self.y, self.z, self.kernel,
                                               self.config["pls"], torch.float64)
            if self._model.lam.shape[0] != self.m_k:
                raise ValueError(f"the reference keeps {self._model.lam.shape[0]} eigenpairs, "
                                 f"the program {self.m_k}")
        return self._model

    def reference(self, i: int, dtype=None) -> dict:
        """The truth in fp64; given any ``dtype``, the control: the same loop
        in fp32 with both products in one TF32 pass, a lower precision than
        the configuration's fp32."""
        u, energies = pls_philox.train(self.model(), self._start(i)["particles"], self.eta,
                                       self.steps, self.philox_seed(i),
                                       tf32_products=dtype is not None)
        return {"particles": u, "energies": energies}

    def compare(self, i: int, answer: dict | None, truth: dict) -> dict:
        if answer is None:
            return {"particles_gap": math.inf, "step_energy_gap": math.inf}
        start = {"particles": self._start(i)["particles"]}
        return {"particles_gap": leaf_gap({"particles": answer["particles"]},
                                          {"particles": truth["particles"]}, start),
                "step_energy_gap": step_gap(answer["energies"], truth["energies"])}
