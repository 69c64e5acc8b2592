"""Calls of ``train_pls`` on the ``quadratic_fused`` tier back to back, as the
library's own usage example makes them for the inducing-point basis (README:
``build_inducing_point_basis(kernel, z, y_at_z, x_train)``,
``GaussianCost(y_train, 0.1)``, ``initialise_particles(1000,
noise_only=False)``, ``train_pls(pls, u0, 20_000, 1e-4,
fast_path="quadratic_fused")``): the configuration's IPB model built once in
set-up, each call from a starting state of a pool drawn from the seed,
``steps`` Euler steps of ``step_size`` with infinite patience, and a
generator seeded per call, from which ``train_pls`` draws the Philox seed of
the kernel B4. The kernel draws its normals itself, so the reference
rebuilds them from that seed (``reference/pls_quadratic.py``)."""

from __future__ import annotations

import math

import torch

from benchmark.entries.train_pls_fused import step_gap
from benchmark.harness import data
from benchmark.harness.compare import leaf_gap
from benchmark.reference import pls_quadratic as reference
from benchmark.reference.pls_philox import philox_seed

END_TO_END = "updates_per_s"


def end_to_end(window_s: float, work: float) -> float:
    return work / window_s


def make_inputs(config: dict, gen: torch.Generator, dtype, device):
    """``(x, y, z)``: sorted uniform inputs on ``x_range``, targets
    sin 2x + label_noise eps and evenly spaced inducing points."""
    lo, hi = config["x_range"]
    rows = int(config["rows"])
    x = torch.sort(lo + (hi - lo) * torch.rand(rows, generator=gen, dtype=dtype, device=device))
    x = x.values[:, None].contiguous()
    eps = torch.randn(rows, generator=gen, dtype=dtype, device=device)
    y = torch.sin(2.0 * x[:, 0]) + config["label_noise"] * eps
    z = torch.linspace(lo, hi, int(config["inducing_points"]), dtype=dtype, device=device)[:, None]
    return x, y, z


def quadratic_steps() -> int | None:
    """The steps the quadratic-tier wrapper has taken in this process, where
    the program counts them."""
    from projected_langevin_sampling_torch.ops.cuda import quadratic_train

    return getattr(quadratic_train.quadratic_train, "steps", None)


def b4_record(device) -> tuple[int, float] | None:
    """B4's own record on the card (runs started, device ms of the last),
    None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from projected_langevin_sampling_torch.ops.cuda import quadratic_train

    return quadratic_train.record(device)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from projected_langevin_sampling_torch.models.basis.inducing_point import (
            build_inducing_point_basis,
        )
        from projected_langevin_sampling_torch.models.costs import GaussianCost
        from projected_langevin_sampling_torch.models.pls import PLS
        from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
        from projected_langevin_sampling_torch.training import spectral_system_host, train_pls

        self._train = train_pls
        self.config, self.traffic, self.device = config, traffic, device
        self.dtype = dtype or getattr(torch, config["dtype"])
        pls = config["pls"]
        gen = data.generator(seed, device)
        self.x, self.y, self.z = make_inputs(config, gen, self.dtype, device)
        self.kernel = {"lengthscales": [float(config["kernel"]["lengthscale"])],
                       "outputscale": float(config["kernel"]["outputscale"])}
        self.noise = float(pls["observation_noise"])
        # the model is built in build_dtype from the inputs and rounded to the
        # training dtype (PERF.md, section 4: the port's fp32 gram at this
        # lengthscale expands |a - b|^2 at |x / l| up to 300)
        build = getattr(torch, config["build_dtype"])
        x_b, z_b = self.x.to(build), self.z.to(build)

        def kernel(dtype, samples):
            as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
            ard = ARDKernel(as_t(self.kernel["lengthscales"]), as_t(self.kernel["outputscale"]))
            return PLSKernel(ard, samples)

        basis = build_inducing_point_basis(kernel(build, x_b), z_b, torch.sin(2.0 * z_b[:, 0]),
                                           x_b)
        m = basis.approximation_dimension
        if m != int(config["inducing_points"]):
            raise ValueError(f"M = {m}, not the {config['inducing_points']} inducing points")
        as_noise = lambda dtype: torch.tensor(self.noise, dtype=dtype, device=device)  # noqa: E731
        sigma_max = float(spectral_system_host(
            basis, GaussianCost(y_train=self.y.to(build), observation_noise=as_noise(build))
        ).sigma.max())
        self.eta = float(pls["step_size"])
        if not self.eta * sigma_max < 2.0:
            raise ValueError(f"eta sigma_max = {self.eta * sigma_max:.4g}: the Euler chain "
                             "diverges at 2")
        cast = lambda t: t.to(self.dtype)  # noqa: E731
        basis = basis.replace(
            kernel=kernel(self.dtype, self.x), x_induce=self.z, y_induce=cast(basis.y_induce),
            gram_induce=cast(basis.gram_induce), base_gram_induce=cast(basis.base_gram_induce),
            base_gram_induce_train=cast(basis.base_gram_induce_train),
            inv_base_gram_induce=cast(basis.inv_base_gram_induce),
            train_projection=cast(basis.train_projection), noise_factor=cast(basis.noise_factor))
        self.pls = PLS(basis=basis, cost=GaussianCost(y_train=self.y,
                                                      observation_noise=as_noise(self.dtype)))
        self.m, self.j = m, int(pls["number_of_particles"])
        self.steps = int(traffic["steps"])
        # one extra start for the warm-up call, after the pool
        self.pool = []
        for _ in range(int(traffic["pool"]) + 1):
            init_seed, call_seed = (int(s) for s in torch.randint(0, 2**62, (2,), generator=gen,
                                                                   device=device))
            particles = self.pls.initialise_particles(
                self.j, noise_only=pls["noise_only"],
                generator=torch.Generator(device=device).manual_seed(init_seed))
            self.pool.append({"particles": particles, "init_seed": init_seed, "seed": call_seed})
        self.answers: dict[int, dict] = {}
        self.b4_ms: dict[int, float | None] = {}
        self._steps_before = None
        self._model = None

    @property
    def shapes(self) -> dict:
        now = quadratic_steps()
        queued = None if now is None or self._steps_before is None else now - self._steps_before
        return {"n": self.x.shape[0], "m_k": self.m, "j": self.j, "steps": self.steps,
                "quadratic_train_steps": queued,
                "b4_ms": [self.b4_ms[i] for i in sorted(self.b4_ms) if i >= 0]}

    def _start(self, i: int) -> dict:
        return self.pool[i % (len(self.pool) - 1)] if i >= 0 else self.pool[-1]

    def philox_seed(self, i: int) -> int:
        """The kernel's seed of call ``i``, as ``train_pls`` draws it."""
        return philox_seed(self._start(i)["seed"], self.device)

    def call(self, i: int) -> float:
        """Run ``i`` of the window (-1: the warm-up); returns the particle
        updates it completed (J times its steps)."""
        if i == 0:
            self._steps_before = quadratic_steps()
        start = self._start(i)
        pls = self.config["pls"]
        before = b4_record(self.device)
        particles, energies = self._train(
            self.pls, start["particles"], number_of_epochs=self.steps, step_size=self.eta,
            early_stopper_patience=math.inf,
            generator=torch.Generator(device=self.device).manual_seed(start["seed"]),
            fast_path=pls["fast_path"], discretisation=pls["discretisation"])
        after = b4_record(self.device)
        # B4's device ms of this call, from its own record: one run started
        if before is not None and after[0] == before[0] + 1:
            self.b4_ms[i] = after[1]
        self.answers[i] = {"particles": particles.detach().clone(), "energies": energies}
        return float(self.j * len(energies))

    def release(self) -> None:
        self.pls = self._train = None

    def model(self) -> reference.Model:
        """The reference's model, in fp64 from the raw inputs."""
        if self._model is None:
            self._model = reference.make_model(self.x, self.y, self.z, self.kernel["lengthscales"],
                                               self.kernel["outputscale"], self.noise)
        return self._model

    def reference(self, i: int, dtype=None) -> dict:
        """The truth in fp64; given any ``dtype``, the control: the same loop
        in fp32 with every product in one TF32 pass, a lower precision than
        the configuration's fp32."""
        start = self._start(i)
        u0 = reference.initial_particles(self.model(), self.j, start["init_seed"], self.dtype)
        u, energies = reference.train(self.model(), u0, self.eta, self.steps, self.philox_seed(i),
                                      tf32_products=dtype is not None)
        return {"start": u0, "particles": u, "energies": energies}

    def compare(self, i: int, answer: dict | None, truth: dict) -> dict:
        if answer is None:
            return {"particles_gap": math.inf, "step_energy_gap": math.inf}
        return {"particles_gap": leaf_gap({"particles": answer["particles"]},
                                          {"particles": truth["particles"]},
                                          {"particles": truth["start"]}),
                "step_energy_gap": step_gap(answer["energies"], truth["energies"])}
