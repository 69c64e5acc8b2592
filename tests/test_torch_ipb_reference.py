"""``train_pls(fast_path="quadratic_fused")`` on the inducing-point basis
against the benchmark's plain reference (``benchmark/reference/pls_quadratic.py``),
which rebuilds the model by direct differences and runs upstream's Euler
loop, not the port's M-space system. At a tiny size on the CPU, in fp64 and
fed the reference's normals, the port's plain loop agrees with it at fp64
rounding; the reference's fp32 TF32 control, a run whose noise factor has
one column flipped, and a run without the prior's M K^-1 drift each read
above the cell's limits."""

import json
import math
import os

import pytest
import torch

import projected_langevin_sampling_torch as pt
import projected_langevin_sampling_torch.training as training
from benchmark.harness.compare import leaf_gap
from benchmark.reference import pls_quadratic as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "limits", "headline_ipb.train.json")) as f:
    LIMITS = json.load(f)

N, M, J, STEPS, ETA, NOISE, LENGTHSCALE = 200, 32, 9, 50, 1e-4, 0.1, 0.1
INIT_SEED, PHILOX_SEED = 2**40 + 3, 2**61 + 5


@pytest.fixture(scope="module")
def inputs():
    gen = torch.Generator().manual_seed(7)
    x = torch.sort(-3.0 + 6.0 * torch.rand(N, generator=gen, dtype=torch.float64)).values[:, None]
    y = torch.sin(2.0 * x[:, 0]) + 0.2 * torch.randn(N, generator=gen, dtype=torch.float64)
    z = torch.linspace(-3.0, 3.0, M, dtype=torch.float64)[:, None]
    return x, y, z


@pytest.fixture(scope="module")
def model(inputs):
    return reference.make_model(*inputs, [LENGTHSCALE], 1.0, NOISE)


@pytest.fixture(scope="module")
def truth(model):
    u0 = reference.initial_particles(model, J, INIT_SEED, torch.float64)
    u, energies = reference.train(model, u0, ETA, STEPS, PHILOX_SEED)
    return {"start": u0, "particles": u, "energies": energies}


def _pls(inputs):
    x, y, z = inputs
    as_t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    kernel = pt.PLSKernel(pt.ARDKernel(as_t([LENGTHSCALE]), as_t(1.0)), x)
    basis = pt.build_inducing_point_basis(kernel, z, torch.sin(2.0 * z[:, 0]), x)
    return pt.PLS(basis, pt.GaussianCost(y_train=y, observation_noise=as_t(NOISE)))


def _readings(answer: dict, truth: dict) -> dict:
    steps = [abs(a - b) / abs(b) for a, b in zip(answer["energies"], truth["energies"])]
    return {"particles_gap": leaf_gap({"particles": answer["particles"]},
                                      {"particles": truth["particles"]},
                                      {"particles": truth["start"]}),
            "step_energy_gap": max(steps) if len(steps) == STEPS else math.inf}


def _port(pls, monkeypatch, fault=lambda args: args) -> dict:
    """``train_pls`` on the ``quadratic_fused`` tier, its plain loop fed the
    reference's normals; ``fault`` rewrites the positional arguments (A, b,
    E, e_bias, S, U0) the tier hands B4's wrapper."""
    noise = reference.normals(PHILOX_SEED, M, J, 0, STEPS, "cpu")
    wrapped = training.quadratic_train
    monkeypatch.setattr(training, "quadratic_train", lambda *args, **kwargs: wrapped(
        *fault(args), **{**kwargs, "noise": noise}))
    u0 = pls.initialise_particles(J, noise_only=False,
                                  generator=torch.Generator().manual_seed(INIT_SEED))
    particles, energies = pt.train_pls(pls, u0, STEPS, ETA, generator=0,
                                       fast_path="quadratic_fused")
    return {"particles": particles, "energies": energies}


def _fails(readings: dict) -> bool:
    return any(readings[name] > limit for name, limit in LIMITS.items())


def test_the_port_agrees_with_the_reference(inputs, truth, monkeypatch):
    readings = _readings(_port(_pls(inputs), monkeypatch), truth)
    assert readings["particles_gap"] < 1e-10 and readings["step_energy_gap"] < 1e-10, readings


def test_the_reference_starts_where_the_port_does(inputs, truth):
    u0 = _pls(inputs).initialise_particles(J, noise_only=False,
                                           generator=torch.Generator().manual_seed(INIT_SEED))
    assert float(torch.max(torch.abs(u0 - truth["start"]))) < 1e-12


def test_the_tf32_control_fails(model, truth):
    u, energies = reference.train(model, truth["start"], ETA, STEPS, PHILOX_SEED,
                                  tf32_products=True)
    readings = _readings({"particles": u, "energies": energies}, truth)
    assert _fails(readings), readings


def _flip_one_column(args):
    a, b, e, e_bias, s, u0 = args
    s = s.clone()
    s[:, M // 2] = -s[:, M // 2]
    return a, b, e, e_bias, s, u0


@pytest.fixture
def drop_prior(inputs):
    """The drift without its M K^-1 U term."""
    prior = M * _pls(inputs).basis.inv_base_gram_induce

    def fault(args):
        a, *rest = args
        return (a - prior, *rest)

    return fault


@pytest.mark.parametrize("fault", ["flipped_column", "dropped_prior"])
def test_a_broken_run_fails(inputs, truth, monkeypatch, drop_prior, fault):
    broken = _flip_one_column if fault == "flipped_column" else drop_prior
    readings = _readings(_port(_pls(inputs), monkeypatch, broken), truth)
    assert _fails(readings), readings
