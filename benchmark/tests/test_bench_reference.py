"""The plain reference against the port at a tiny size on the CPU: every
cell's answers agree with it within the cell's limits; the reference in
float32 put in the program's place does not; and a run whose timed path is
broken underneath (a step that returns its state unchanged, half of the
batch left out with the mean over the rest, an answer altered where it is
produced) comes out not correct."""

import copy
import json
import os

import pytest
import torch

from benchmark.run import ROOT, Spec, measure

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

# tiny stand-ins of each cell's sizes: rows, and what the traffic runs
TINY = {
    "kin8nm_regression.svgp_fit": ({"rows": 400}, {"epochs": 6}),
    "kin8nm_regression.gp_fit": ({"rows": 400}, {"epochs": 8, "subsample_size": 200}),
    "rice_classification_j1000.train": ({"rows": 400}, {}),
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_spec(cell: str) -> Spec:
    spec = Spec(BENCH, cell)
    config, traffic = TINY[cell]
    spec.config = {**copy.deepcopy(spec.config), **config}
    if "svgp" in spec.config:
        spec.config["svgp"]["batch_size"] = 128
    spec.config["pls"]["number_of_particles"] = 9
    spec.config["pls"]["simulation_duration"] = 0.05  # 50 steps at eta 1e-3
    spec.traffic = {**spec.traffic, **traffic, "pool": 2, "check_calls": 2}
    return spec


def run(spec: Spec, seed: int = 2**31 + 7):
    entry = spec.entry()
    cell = entry.Cell(spec.config, spec.traffic, seed, torch.device("cpu"))
    cell.call(-1)
    device = lambda: {"platform": "cpu", "kind": "cpu", "count": 1,  # noqa: E731
                      "memory_peak_bytes": 0}
    return measure(spec, entry, cell, seed, 0.0, False, 0.0, lambda: None, device)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run(tiny_spec(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", Spec(BENCH, cell).entry().END_TO_END}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    spec = tiny_spec(cell)
    cell_ = spec.entry().Cell(spec.config, spec.traffic, 2**31 + 9, torch.device("cpu"))
    truth = cell_.reference(0)
    readings = cell_.compare(0, cell_.reference(0, torch.float32), truth)
    assert any(readings[k] > limit for k, limit in spec.limits.items()), readings


def _stuck(monkeypatch):
    """Every step of the program's runner returns its state unchanged."""
    import projected_langevin_sampling_torch.models.gaussian_process.training as gp_training
    import projected_langevin_sampling_torch.training as training
    from projected_langevin_sampling_torch.utils.early_stopper import run_training

    def broken(step, state, *args, **kwargs):
        def same(t, s):
            out = step(t, s)
            return (s, *out[1:])

        if kwargs.get("fallback") is not None:
            kwargs["fallback"] = (lambda f: lambda t, s: (s, *f(t, s)[1:]))(kwargs["fallback"])
        return run_training(same, state, *args, **kwargs)

    monkeypatch.setattr(gp_training, "run_training", broken)
    monkeypatch.setattr(training, "run_training", broken)


def _half_batch(monkeypatch):
    """The data term over the first half of each batch, scaled as a mean."""
    from projected_langevin_sampling_torch.models.costs.smoothed_bernoulli import (
        SmoothedBernoulliCost,
    )
    from projected_langevin_sampling_torch.models.gaussian_process.exact_gp import ExactGP
    from projected_langevin_sampling_torch.models.gaussian_process.svgp import SVGP

    elbo = SVGP.elbo
    monkeypatch.setattr(SVGP, "elbo", lambda self, x, y, n: elbo(self, x[: len(x) // 2],
                                                                 y[: len(y) // 2], n))
    mll = ExactGP.log_marginal_likelihood

    def half_mll(self, *args, **kwargs):
        h = self.y_train.shape[0] // 2
        half = self.replace(x_train=self.x_train[:h], y_train=self.y_train[:h])
        return 2.0 * mll(half, *args, **kwargs)

    monkeypatch.setattr(ExactGP, "log_marginal_likelihood", half_mll)
    dc = SmoothedBernoulliCost.calculate_cost_derivative

    def half_dc(self, f, *args, **kwargs):
        out = dc(self, f, *args, **kwargs)
        h = out.shape[0] // 2
        return torch.cat([2.0 * out[:h], torch.zeros_like(out[h:])])

    monkeypatch.setattr(SmoothedBernoulliCost, "calculate_cost_derivative", half_dc)


def _altered(monkeypatch):
    """One number of each answer moved by 1e-4 where the program returns it."""
    import projected_langevin_sampling_torch.models.gaussian_process.training as gp_training
    import projected_langevin_sampling_torch.training as training

    fit_svgp, fit_exact_gp, train_pls = (gp_training.fit_svgp, gp_training.fit_exact_gp,
                                         training.train_pls)

    def svgp(*a, **k):
        model, losses = fit_svgp(*a, **k)
        return model.replace(mean_constant=model.mean_constant + 1e-4), losses

    def exact(*a, **k):
        model, losses = fit_exact_gp(*a, **k)
        return model.replace(mean_constant=model.mean_constant + 1e-4), losses

    def pls(*a, **k):
        particles, energies = train_pls(*a, **k)
        particles = particles.clone()
        particles[0, 0] += 1e-4
        return particles, energies

    monkeypatch.setattr(gp_training, "fit_svgp", svgp)
    monkeypatch.setattr(gp_training, "fit_exact_gp", exact)
    monkeypatch.setattr(training, "train_pls", pls)


@pytest.mark.parametrize("fault", [_stuck, _half_batch, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(tiny_spec(cell))
    assert not result["correct"], result["checks"]
