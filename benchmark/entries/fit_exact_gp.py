"""Calls of ``fit_exact_gp`` back to back, as the mains' kernel fit makes
them: each call on the subsample of training rows nearest a random row (the
pool holds the configuration's number of iterations of them, each drawn from
the seed), from lengthscales 1, outputscale 1, noise 1 and mean 0, Adam at
the configuration's rate for the traffic's epochs with infinite patience."""

from __future__ import annotations

import math

import torch

from benchmark.harness import data
from benchmark.harness.compare import leaf_gap, trace_gap
from benchmark.reference import exact_gp as reference

END_TO_END = "exact_gp_epoch_ms"


def end_to_end(window_s: float, work: float) -> float:
    return 1e3 * window_s / work


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from projected_langevin_sampling_torch.models.gaussian_process.training import (
            fit_exact_gp,
        )
        from projected_langevin_sampling_torch.ops.kernels import ARDKernel

        self._fit, self._kernel = fit_exact_gp, ARDKernel
        self.config, self.traffic, self.device = config, traffic, device
        self.dtype = dtype or getattr(torch, config["dtype"])
        gen = data.generator(seed, device)
        x, y = data.make_dataset(config, gen, self.dtype, device)
        size = int(traffic.get("subsample_size", config["kernel_fit"]["subsample_size"]))
        pool = int(config["kernel_fit"]["number_of_iterations"])
        # one extra subsample for the warm-up call, after the pool
        self.pool = []
        for _ in range(pool + 1):
            rows = data.nearest_rows(x, size, gen)
            self.pool.append((x[rows].contiguous(), y[rows].contiguous()))
        self.answers: dict[int, dict] = {}

    @property
    def shapes(self) -> dict:
        x = self.pool[0][0]
        return {"n": x.shape[0], "d": x.shape[1], "epochs": int(self.traffic["epochs"])}

    def _rows(self, i: int):
        return self.pool[i % (len(self.pool) - 1)] if i >= 0 else self.pool[-1]

    def _initial(self, d: int, dtype) -> dict:
        zero = torch.zeros((), dtype=dtype, device=self.device)
        return {"mean_constant": zero, "log_lengthscales": torch.zeros(d, dtype=dtype, device=self.device),
                "log_outputscale": zero, "log_noise": zero}

    def call(self, i: int) -> float:
        """Fit ``i`` of the window (-1: the warm-up); returns its epochs."""
        x, y = self._rows(i)
        d = x.shape[1]
        kernel = self._kernel(lengthscales=torch.ones(d, dtype=self.dtype, device=self.device),
                              outputscale=torch.tensor(1.0, dtype=self.dtype, device=self.device))
        gp, losses = self._fit(x, y, kernel, noise=1.0, mean_constant=0.0,
                               learning_rate=self.config["kernel_fit"]["learning_rate"],
                               number_of_epochs=int(self.traffic["epochs"]),
                               early_stopper_patience=math.inf)
        self.answers[i] = {
            "params": {"mean_constant": gp.mean_constant.detach().clone(),
                       "log_lengthscales": torch.log(gp.kernel.lengthscales).detach().clone(),
                       "log_outputscale": torch.log(gp.kernel.outputscale).detach().clone(),
                       "log_noise": torch.log(gp.noise).detach().clone()},
            "losses": losses,
        }
        return float(len(losses))

    def release(self) -> None:
        self._fit = self._kernel = None

    def reference(self, i: int, dtype=None) -> dict:
        dtype = dtype or self.dtype
        x, y = self._rows(i)
        params, losses = reference.fit(
            x.to(dtype), y.to(dtype), self._initial(x.shape[1], dtype), int(self.traffic["epochs"]),
            self.config["kernel_fit"]["learning_rate"])
        return {"params": params, "losses": losses}

    def compare(self, i: int, answer: dict | None, truth: dict) -> dict:
        if answer is None:
            return {"fit_gap": math.inf, "loss_gap": math.inf}
        start = self._initial(self._rows(i)[0].shape[1], torch.float64)
        return {"fit_gap": leaf_gap(answer["params"], truth["params"], start),
                "loss_gap": trace_gap(answer["losses"], truth["losses"])}
