"""The port harness's runners and trainers against the JAX harness, on the
CPU in fp64.

- The step-size search's control flow, with both harnesses' ``train_pls``
  replaced by one deterministic stand-in: the same candidates run, the same
  "diverged" rule and relative-change break fire, ``equilibrate_spread``
  runs the same chunks, and the same step size, epochs and particles come
  back. Likewise the SVGP learning-rate search.
- The subsample exact GPs (plain and Dirichlet) and the inducing points on
  a 300-row set: kernels, noise and mean constant at rtol 1e-8.
- ``train_pls(parallel=...)`` on a world-size-1 gloo group is ``train_pls``
  bit for bit, and a group of another size, or none, raises.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from experiments import runners as jrunners
from experiments.data import Data as JData
from experiments.data import ExperimentData as JExperimentData
from experiments.data import ProblemType as JProblemType
from experiments_torch import runners, trainers
from experiments_torch.data import Data, ExperimentData, ProblemType
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (  # noqa: E501
    ConditionalVarianceInducingPointSelector,
)
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.kernels import ARDKernel
from projected_langevin_sampling_torch.training import train_pls as port_train_pls
from projected_langevin_sampling_tpu.models.gaussian_process import (
    GaussianLikelihood as JGaussianLikelihood,
)
from projected_langevin_sampling_tpu.models.inducing_point_selectors import (
    ConditionalVarianceInducingPointSelector as JConditionalVariance,
)
from projected_langevin_sampling_tpu.models.pls import PLS as JPLS
from projected_langevin_sampling_tpu.ops.kernels import ARDKernel as JARDKernel
from projected_langevin_sampling_tpu.ops.kernels import PLSKernel as JPLSKernel
from projected_langevin_sampling_torch.models.gaussian_process import GaussianLikelihood
from projected_langevin_sampling_torch.ops.kernels import PLSKernel
from tests.torch_parity import carried, jax_onb, to_np

RTOL = 1e-8


def _experiment_pair(x, y, n_train):
    parts = {"train": slice(0, n_train), "test": slice(n_train, None)}
    jdata = JExperimentData(
        name="d", problem_type=JProblemType.REGRESSION,
        full=JData(x=jnp.asarray(x), y=jnp.asarray(y), name="full"),
        **{k: JData(x=jnp.asarray(x[s]), y=jnp.asarray(y[s]), name=k) for k, s in parts.items()})
    tdata = ExperimentData(
        name="d", problem_type=ProblemType.REGRESSION,
        full=Data(x=torch.as_tensor(x), y=torch.as_tensor(y), name="full"),
        **{k: Data(x=torch.as_tensor(x[s]), y=torch.as_tensor(y[s]), name=k)
           for k, s in parts.items()})
    return jdata, tdata


def _stand_in(calls, final_energies, e0):
    """A deterministic ``train_pls`` for both harnesses: candidate k (by
    call order) records its arguments, multiplies the particles by
    1 + step, and returns ``number_of_epochs`` energies falling linearly
    from ``e0`` to ``final_energies[k]`` (a list entry of None: rising to
    2 e0; a pair (lo, last): dipping to lo, ending at last)."""

    def train_pls(pls, particles, number_of_epochs, step_size, early_stopper_patience,
                  seed=None, fast_path="auto", discretisation="euler", parallel=None, **_):
        k = len(calls)
        calls.append((number_of_epochs, float(step_size), seed, fast_path, discretisation,
                      parallel))
        target = final_energies[min(k, len(final_energies) - 1)]
        n = int(number_of_epochs)
        if target is None:
            energies = list(np.linspace(e0, 2 * e0, n + 1)[1:])
        elif isinstance(target, tuple):
            lo, last = target
            energies = list(np.linspace(e0, lo, n // 2 + 1)[1:]) + list(
                np.linspace(lo, last, n - n // 2 + 1)[1:])
        else:
            energies = list(np.linspace(e0, target, n + 1)[1:])
        return particles * (1.0 + float(step_size)), [float(e) for e in energies]

    return train_pls


# (final energies of the candidates in call order, in units of E0; the
# search's settings). Candidate 0 at the largest step.
SCENARIOS = {
    # candidates 1 and 2 land within 1% of each other: break after 2
    "relative_break": ([0.3, 0.2, 0.199], dict(metric="loss")),
    # candidate 0 rises above E0: diverged and skipped; 1 dips below E0 but
    # ends above it: diverged; then a break
    "diverged": ([None, (0.5, 1.2), 0.25, 0.2501, 0.1], dict(metric="loss")),
    "all_diverged": ([None], dict(metric="loss")),
    # no break (min change 0); the best by loss is the last
    "no_break": ([0.5, 0.4, 0.3, 0.2], dict(metric="loss", min_change=0.0)),
    # the winning chain continues in chunks until the spread settles
    "equilibrate": ([0.5, 0.4, 0.3], dict(metric="loss", min_change=0.0, equilibrate=0.05)),
    # the selection by a predictive metric (mse on the train split): the
    # largest steps blow the particles up, so the choice does not depend on
    # the predictive noise each package draws
    "by_mse": ([0.5, 0.4, 0.3], dict(metric="mse", min_change=0.0, steps=3)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_step_size_search_control_flow_matches_jax(scenario, monkeypatch):
    finals, opts = SCENARIOS[scenario]
    jbasis, jcost, x, y = jax_onb(n=40, m=10)
    tbasis, tcost = carried(jbasis, jcost)
    jpls, tpls = JPLS(basis=jbasis, cost=jcost), PLS(basis=tbasis, cost=tcost)
    jdata, tdata = _experiment_pair(x, y, 40)
    u = np.random.default_rng(1).normal(size=(jbasis.approximation_dimension, 6))
    if scenario == "by_mse":
        u = 0.01 * u
    e0 = float(jpls.calculate_energy_potential(jnp.asarray(u)))
    np.testing.assert_allclose(float(tpls.calculate_energy_potential(torch.as_tensor(u))), e0,
                               rtol=1e-12)
    energies = [None if f is None else (tuple(v * e0 for v in f) if isinstance(f, tuple)
                                        else f * e0) for f in finals]
    results = {}
    for name, module, pls, data, particles in (
            ("jax", jrunners, jpls, jdata, jnp.asarray(u)),
            ("torch", runners, tpls, tdata, torch.as_tensor(u))):
        calls = []
        train = _stand_in(calls, energies, e0)
        if scenario == "by_mse":
            # the largest step multiplies the particles by 1e3, the next by 1e2
            base = train

            def train(pls, particles, number_of_epochs, step_size, *args, _base=base, **kw):
                out, e = _base(pls, particles, number_of_epochs, step_size, *args, **kw)
                return out * {0: 1e3, 1: 1e2}.get(len(calls) - 1, 1.0), e
        monkeypatch.setattr(module, "train_pls", train)
        out = module.train_pls_runner(
            pls=pls, particle_name="p", experiment_data=data, simulation_duration=0.05,
            maximum_number_of_steps=1000 if opts.get("equilibrate") else 400,
            early_stopper_patience=math.inf,
            number_of_step_searches=opts.get("steps", 5), step_size_upper=1e-2,
            minimum_change_in_energy_potential=opts.get("min_change", 1e-2), seed=3,
            particles=particles, metric_to_optimise=opts["metric"],
            fast_path="off", discretisation="preconditioned",
            equilibrate_spread=opts.get("equilibrate"),
        )
        results[name] = (out, calls)
    (j_u, j_lr, j_epochs), j_calls = results["jax"]
    (t_u, t_lr, t_epochs), t_calls = results["torch"]
    assert t_calls == j_calls
    assert (t_lr, t_epochs) == (j_lr, j_epochs)
    np.testing.assert_allclose(to_np(t_u), to_np(j_u), rtol=1e-12)
    # what each scenario exercises: (candidates run, index of the winner)
    runs, winner = {"relative_break": (3, 2), "diverged": (4, 2), "all_diverged": (5, None),
                    "no_break": (5, 3), "equilibrate": (5, 2), "by_mse": (3, 2)}[scenario]
    steps = np.logspace(np.log10(1e-2), np.log10(0.05 / (1000 if opts.get("equilibrate") else 400)),
                        opts.get("steps", 5))
    assert len(t_calls) == runs if scenario != "equilibrate" else len(t_calls) > runs
    assert t_lr == (None if winner is None else float(steps[winner]))
    if scenario == "all_diverged":
        assert t_epochs == 0


def test_svgp_learning_rate_search_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(80, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=80)
    jdata, tdata = _experiment_pair(x, y, 60)
    z = x[:8]
    jkernel = JPLSKernel(base_kernel=JARDKernel(jnp.asarray([0.9, 1.1]), jnp.asarray(1.2)),
                         approximation_samples=jnp.asarray(z))
    tkernel = PLSKernel(base_kernel=ARDKernel(torch.tensor([0.9, 1.1], dtype=torch.float64),
                                              torch.tensor(1.2, dtype=torch.float64)),
                        approximation_samples=torch.as_tensor(z))
    kwargs = dict(model_name="svgp", seed=0, number_of_epochs=8, batch_size=5000,
                  learning_rate_upper=0.1, learning_rate_lower=0.001,
                  number_of_learning_rate_searches=3, is_fixed=True,
                  early_stopper_patience=100.0, observation_noise=0.2, mean_constant=0.1)
    jmodel, jlosses, jlr = jrunners.train_svgp_runner(
        experiment_data=jdata, inducing_points=JData(x=jnp.asarray(z)), kernel=jkernel,
        likelihood=JGaussianLikelihood(noise=jnp.asarray(0.2)),
        models_path=str(tmp_path / "jax"), **kwargs)
    tmodel, tlosses, tlr = runners.train_svgp_runner(
        experiment_data=tdata, inducing_points=Data(x=torch.as_tensor(z)), kernel=tkernel,
        likelihood=GaussianLikelihood(noise=torch.tensor(0.2, dtype=torch.float64)),
        models_path=str(tmp_path / "torch"), **kwargs)
    assert tlr == jlr
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    for name in ("variational_mean", "variational_chol", "mean_constant"):
        np.testing.assert_allclose(to_np(getattr(tmodel, name)), to_np(getattr(jmodel, name)),
                                   rtol=RTOL, atol=1e-12)
    # the second run loads each candidate's checkpoint
    again, losses, lr = runners.train_svgp_runner(
        experiment_data=tdata, inducing_points=Data(x=torch.as_tensor(z)), kernel=tkernel,
        likelihood=GaussianLikelihood(noise=torch.tensor(0.2, dtype=torch.float64)),
        models_path=str(tmp_path / "torch"), **kwargs)
    assert (losses, lr) == (tlosses, tlr)


def _gp_data(n=300, d=3, classification=False):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d))
    f = np.sin(x[:, 0]) + 0.5 * x[:, 1] * x[:, 2]
    y = (f + 0.3 * rng.normal(size=n) > 0).astype(float) if classification else f
    return x, y


@pytest.mark.parametrize("dirichlet", [False, True])
def test_subsample_gp_runners_and_inducing_points_match_jax(tmp_path, dirichlet):
    x, y = _gp_data(classification=dirichlet)
    jdata, tdata = _experiment_pair(x, y, 240)
    kwargs = dict(subsample_size=100, seed=0, number_of_epochs=30, learning_rate=0.01,
                  number_of_iterations=2, early_stopper_patience=100.0)
    jrun = jrunners.dirichlet_exact_gp_runner if dirichlet else jrunners.exact_gp_runner
    trun = runners.dirichlet_exact_gp_runner if dirichlet else runners.exact_gp_runner
    jmodels = jrun(experiment_data=jdata, kernel=JARDKernel(jnp.ones(3), jnp.asarray(1.0)),
                   model_path=str(tmp_path / "jm"), data_path=str(tmp_path / "jd"), **kwargs)
    tkernel = ARDKernel(torch.ones(3, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
    tmodels = trun(experiment_data=tdata, kernel=tkernel, model_path=str(tmp_path / "tm"),
                   data_path=str(tmp_path / "td"), **kwargs)
    assert len(tmodels) == len(jmodels) == (4 if dirichlet else 2)
    for tm, jm in zip(tmodels, jmodels):
        np.testing.assert_array_equal(to_np(tm.x_train), to_np(jm.x_train))  # the kNN rows
        for name in ("mean_constant", "noise"):
            np.testing.assert_allclose(to_np(getattr(tm, name)), to_np(getattr(jm, name)),
                                       rtol=RTOL)
        np.testing.assert_allclose(to_np(tm.kernel.lengthscales), to_np(jm.kernel.lengthscales),
                                   rtol=RTOL)
        np.testing.assert_allclose(to_np(tm.kernel.outputscale), to_np(jm.kernel.outputscale),
                                   rtol=RTOL)
    # a second run loads the checkpoints the first wrote
    again = trun(experiment_data=tdata, kernel=tkernel, model_path=str(tmp_path / "tm"),
                 data_path=str(tmp_path / "td"), **kwargs)
    for a, b in zip(again, tmodels):
        np.testing.assert_array_equal(to_np(a.kernel.lengthscales), to_np(b.kernel.lengthscales))

    # inducing points on the first model's kernel
    jz = jrunners.inducing_points_runner(0, JConditionalVariance(), jdata.train, 15,
                                         jmodels[0].kernel)
    tz = runners.inducing_points_runner(0, ConditionalVarianceInducingPointSelector(), tdata.train,
                                        15, tmodels[0].kernel)
    assert tz.name == jz.name == "induce"
    np.testing.assert_array_equal(to_np(tz.x), to_np(jz.x))
    np.testing.assert_array_equal(to_np(tz.y), to_np(jz.y))


@pytest.fixture
def lone_gloo_group():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_parallel_train_pls_on_one_rank_is_train_pls_bit_for_bit(lone_gloo_group):
    jbasis, jcost, _, _ = jax_onb(n=48, m=12)
    pls = PLS(*carried(jbasis, jcost))
    u = pls.initialise_particles(8, generator=0)
    for fast_path, discretisation in (("auto", "euler"), ("off", "preconditioned")):
        kwargs = dict(number_of_epochs=60, step_size=1e-3, early_stopper_patience=math.inf,
                      seed=5, fast_path=fast_path, discretisation=discretisation)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "auto" resolving to the spectral tier
            mesh_u, mesh_e = trainers.train_pls(pls, u, parallel={"data": 1, "particles": 1},
                                                **kwargs)
            one_u, one_e = port_train_pls(pls, u, **kwargs)
        assert torch.equal(mesh_u, one_u) and mesh_e == one_e and len(one_e) == 60
    with pytest.raises(ValueError, match="2 ranks"):
        trainers.train_pls(pls, u, 10, 1e-3, math.inf, parallel={"data": 1, "particles": 2})


def test_parallel_train_pls_without_a_group_raises():
    jbasis, jcost, _, _ = jax_onb(n=48, m=12)
    pls = PLS(*carried(jbasis, jcost))
    u = pls.initialise_particles(8, generator=0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="none is initialised"):
        trainers.train_pls(pls, u, 10, 1e-3, math.inf, parallel={"data": 1, "particles": 1})

