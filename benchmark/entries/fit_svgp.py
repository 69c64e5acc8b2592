"""Calls of ``fit_svgp`` back to back, as the regression main's SVGP
learning-rate search makes them: each call a fresh SVGP (q(u) = N(0, I)
whitened, the noise and mean constant drawn from the seed) on the r-kernel
over the inducing points, kernel and inducing points frozen, SGD at the
traffic's rate for its epochs with infinite patience, the epochs'
permutations from a generator seeded per call."""

from __future__ import annotations

import math

import torch

from benchmark.harness import data
from benchmark.harness.compare import leaf_gap, trace_gap
from benchmark.reference import svgp as reference

END_TO_END = "svgp_epoch_ms"


def end_to_end(window_s: float, work: float) -> float:
    return 1e3 * window_s / work


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from projected_langevin_sampling_torch.models.gaussian_process import (
            GaussianLikelihood,
            init_svgp,
        )
        from projected_langevin_sampling_torch.models.gaussian_process.training import fit_svgp
        from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel

        self._fit, self._init, self._likelihood = fit_svgp, init_svgp, GaussianLikelihood
        self.config, self.traffic, self.device = config, traffic, device
        self.dtype = dtype or getattr(torch, config["dtype"])
        gen = data.generator(seed, device)
        self.x, self.y = data.make_dataset(config, gen, self.dtype, device)
        self.kernel = data.kernel_hyperparameters(config, gen, self.dtype, device)
        m = data.number_of_inducing_points(config, self.x.shape[0])
        self.z = self.x[data.inducing_indices(self.x.shape[0], m, gen, device)]
        self.pls_kernel = PLSKernel(
            ARDKernel(self.kernel["lengthscales"], self.kernel["outputscale"]), self.z)
        h = config["hyperparameters"]
        # one extra start for the warm-up call, after the pool
        self.pool = [
            {"noise": data.uniform(gen, h["noise"], (), self.dtype, device, log=True),
             "mean_constant": data.uniform(gen, h["mean_constant"], (), self.dtype, device),
             "seed": int(torch.randint(0, 2**62, (1,), generator=gen, device=device))}
            for _ in range(int(traffic["pool"]) + 1)
        ]
        self.answers: dict[int, dict] = {}

    @property
    def shapes(self) -> dict:
        svgp = self.config["svgp"]
        return {"n": self.x.shape[0], "m": self.z.shape[0], "d": self.x.shape[1],
                "batch_size": svgp["batch_size"], "epochs": int(self.traffic["epochs"])}

    def _start(self, i: int) -> dict:
        return self.pool[i % (len(self.pool) - 1)] if i >= 0 else self.pool[-1]

    def call(self, i: int) -> float:
        """Fit ``i`` of the window (-1: the warm-up); returns the epochs it
        completed."""
        start = self._start(i)
        svgp = self._init(mean_constant=start["mean_constant"], kernel=self.pls_kernel,
                          likelihood=self._likelihood(noise=start["noise"]), x_induce=self.z)
        cfg = self.config["svgp"]
        fitted, losses = self._fit(
            svgp, self.x, self.y, number_of_epochs=int(self.traffic["epochs"]),
            batch_size=cfg["batch_size"], learning_rate=cfg["learning_rate"],
            learn_inducing_locations=cfg["learn_inducing_locations"],
            learn_kernel_parameters=cfg["learn_kernel_parameters"],
            learn_observation_noise=cfg["learn_observation_noise"],
            early_stopper_patience=math.inf,
            generator=torch.Generator(device=self.device).manual_seed(start["seed"]),
        )
        if fitted is None:
            self.answers[i] = None
            return 0.0
        self.answers[i] = {
            "params": {"mean_constant": fitted.mean_constant.detach().clone(),
                       "variational_mean": fitted.variational_mean.detach().clone(),
                       "variational_chol": fitted.variational_chol.detach().clone(),
                       "log_noise": torch.log(fitted.likelihood.noise).detach().clone()},
            "losses": losses,
        }
        return float(len(losses))

    def release(self) -> None:
        """Free what the program holds beyond the answers."""
        self.pls_kernel = self._fit = self._init = None

    def _initial(self, start: dict) -> dict:
        m = self.z.shape[0]
        return {"mean_constant": start["mean_constant"],
                "variational_mean": torch.zeros(m, dtype=self.dtype, device=self.device),
                "variational_chol": torch.eye(m, dtype=self.dtype, device=self.device),
                "log_noise": torch.log(start["noise"])}

    def reference(self, i: int, dtype=None) -> dict:
        """The plain reference's answer to call ``i``'s inputs in ``dtype``
        (the configuration's by default)."""
        dtype = dtype or self.dtype
        start = self._start(i)
        to = lambda t: t.to(dtype)  # noqa: E731
        cfg = self.config["svgp"]
        params, losses = reference.fit(
            to(self.x), to(self.y), to(self.z), to(self.kernel["lengthscales"]),
            to(self.kernel["outputscale"]),
            {k: to(v) for k, v in self._initial(start).items()},
            int(self.traffic["epochs"]), cfg["batch_size"], cfg["learning_rate"],
            torch.Generator(device=self.device).manual_seed(start["seed"]))
        return {"params": params, "losses": losses}

    def compare(self, i: int, answer: dict | None, truth: dict) -> dict:
        if answer is None:
            return {"fit_gap": math.inf, "loss_gap": math.inf}
        start = self._initial(self._start(i))
        return {"fit_gap": leaf_gap(answer["params"], truth["params"], start),
                "loss_gap": trace_gap(answer["losses"], truth["losses"])}
