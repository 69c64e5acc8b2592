"""Scale-out of the PyTorch port (``projected_langevin_sampling_torch/parallel``
and ``PLS.predict_samples(mesh=)``) on the CPU, in fp64.

Ranks are processes joined by gloo (``tests/torch_parallel_worker.py``,
which imports no JAX). This module builds the models with the JAX package,
passes them to the ranks as numpy parameters, and holds what they return to:

- the JAX package's sharded steps on a 4-device mesh of its own (rtol 1e-9,
  the tiers' tolerance: fp64 reassociation over a few steps);
- the port's single-device trainer on the whole particle matrix, which the
  training tests hold to JAX (rtol 1e-9; the sharded energies are sums in
  another order), and JAX's ``parallel_train_pls`` where its noise can be
  reproduced (the off, quadratic and spectral tiers, as
  ``tests/test_torch_training.py`` reproduces them);
- the single-device chunked predict at the same block count (rtol 1e-10,
  the build and prediction tolerance).

One spawn of 4 ranks runs every multi-rank job and one of 2 ranks the
two-process run. The plain versions of the kernels on column shards and
B5's partial mode on row shards are held in this process.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.models.pls import PLS as TPLS
from projected_langevin_sampling_torch.ops.cuda import fused_update as tfused
from projected_langevin_sampling_torch.ops.cuda import general_train as tgen
from projected_langevin_sampling_torch.ops.cuda import quadratic_train as tquad
from projected_langevin_sampling_torch.ops.cuda import spectral_train as tspec
from projected_langevin_sampling_torch.parallel import auto as tauto
from projected_langevin_sampling_torch.parallel import initialize_multi_host, make_mesh
from projected_langevin_sampling_torch.parallel.mesh import data_rows, particle_columns
from projected_langevin_sampling_torch.utils.columns import ColumnShard
from projected_langevin_sampling_torch.utils.early_stopper import replay_early_stopper
from projected_langevin_sampling_torch.utils.prng import as_generator
from projected_langevin_sampling_tpu.models.pls import PLS as JPLS
from projected_langevin_sampling_tpu.parallel import make_mesh as jmake_mesh
from projected_langevin_sampling_tpu.parallel import (
    parallel_langevin_steps_with_noise as j_steps_with_noise,
)
from projected_langevin_sampling_tpu.parallel import parallel_train_pls as j_parallel_train_pls
from projected_langevin_sampling_tpu.training import spectral_system_host as j_spectral_system
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import (
    basis_params,
    carried,
    carried_ipb,
    cost_params,
    ipb_params,
    jax_cost,
    jax_ipb,
    jax_onb,
    to_np,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
J, ETA = 16, 1e-3
STEPS, TRAIN_STEPS, PATIENCE = 5, 120, 0.005  # the patience stops every case mid-run
RTOL, PREDICT_RTOL = 1e-9, 1e-10
MESHES = [(1, 4), (2, 2), (4, 1)]
# costs with no closed form in B5, stepped on a 2 x 2 mesh
NO_CLOSED_FORM = ("onb_probit", "onb_smoothed")
# off, quadratic and spectral on the ONB Gaussian model with JAX's own draws
JAX_NOISE_TIERS = ("off", "quadratic", "spectral")


@functools.lru_cache(maxsize=None)
def _models():
    """name -> (JAX basis, JAX cost, port basis, port cost, u0 numpy)."""
    onb, gauss, x, _ = jax_onb()
    ipb, ipb_gauss, x_ipb, _ = jax_ipb()
    out = {}
    for name, jbasis, jcost in (
        ("onb_gauss", onb, gauss),
        ("ipb_gauss", ipb, ipb_gauss),
        ("onb_bern", onb, jax_cost("bernoulli", x)),
        ("ipb_bern", ipb, jax_cost("bernoulli", x_ipb)),
        ("onb_probit", onb, jax_cost("bernoulli_probit", x)),
        ("onb_smoothed", onb, jax_cost("smoothed", x)),
    ):
        tbasis, tcost = (carried if name.startswith("onb") else carried_ipb)(jbasis, jcost)
        u0 = np.random.default_rng(len(out)).normal(size=(jbasis.approximation_dimension, J))
        out[name] = (jbasis, jcost, tbasis, tcost, u0)
    return out


def _spec(name):
    jbasis, jcost, _, _, u0 = _models()[name]
    kind = "onb" if name.startswith("onb") else "ipb"
    params = basis_params(jbasis) if kind == "onb" else ipb_params(jbasis)
    return {"basis": (kind, params), "cost": (type(jcost).__name__, cost_params(jcost)),
            "u0": u0}


@functools.lru_cache(maxsize=None)
def _step_noise(name):
    m = _models()[name][0].approximation_dimension
    return np.random.default_rng(11).normal(size=(STEPS, m, J))


@functools.lru_cache(maxsize=None)
def _jax_train_noise(tier):
    """The normals JAX's scan draws from its per-step keys on the ONB
    Gaussian model, in U coordinates (the spectral tier's W-space draws
    mapped through JAX's own eigenbasis, as tests/test_torch_training.py)."""
    jbasis, jcost = _models()["onb_gauss"][:2]
    keys = jax.random.split(as_key(123), TRAIN_STEPS)
    if tier == "spectral":
        m_k = jbasis.approximation_dimension
        eps_w = jax.vmap(lambda k: jax.random.normal(k, (m_k, J), dtype=jnp.float64))(keys)
        q_out = np.asarray(j_spectral_system(jbasis, jcost).q_out)
        return q_out[None] @ np.asarray(eps_w)
    return np.stack([np.asarray(jbasis.sample_update_noise(J, k)) for k in keys])


def _train_noise(name, seed=5):
    m = _models()[name][0].approximation_dimension
    return np.random.default_rng(seed).normal(size=(TRAIN_STEPS, m, J))


# (key, model, fast_path, patience, noise: "jax" | "rng" | None (a seed), discretisation)
TRAIN_CASES = [
    ("off_jax", "onb_gauss", "off", np.inf, "jax", "euler"),
    ("off_jax_stop", "onb_gauss", "off", PATIENCE, "jax", "euler"),
    ("quadratic_jax", "onb_gauss", "quadratic", np.inf, "jax", "euler"),
    ("spectral_jax", "onb_gauss", "spectral", np.inf, "jax", "euler"),
    ("spectral_jax_stop", "onb_gauss", "spectral", PATIENCE, "jax", "euler"),
    ("spectral_ipb", "ipb_gauss", "spectral", np.inf, "rng", "euler"),
    ("spectral_ipb_stop", "ipb_gauss", "spectral", PATIENCE, "rng", "euler"),
    ("spectral_precond", "onb_gauss", "auto", np.inf, "rng", "preconditioned"),
    ("general_fused", "onb_bern", "general_fused", np.inf, "rng", "euler"),
    ("general_fused_stop", "onb_bern", "general_fused", PATIENCE, "rng", "euler"),
    ("general_fused_precond", "onb_bern", "general_fused", np.inf, "rng", "preconditioned"),
    ("general_fused_ipb_wspace", "ipb_bern", "general_fused", np.inf, "rng", "euler"),
    ("quadratic_fused_ipb", "ipb_gauss", "quadratic_fused", np.inf, "rng", "euler"),
    ("quadratic_fused_ipb_stop", "ipb_gauss", "quadratic_fused", PATIENCE, "rng", "euler"),
    ("off_ipb_stop", "ipb_bern", "off", PATIENCE, "rng", "euler"),
    ("seeded_spectral", "onb_gauss", "spectral", np.inf, None, "euler"),
    ("seeded_general_fused_stop", "onb_bern", "general_fused", PATIENCE, None, "euler"),
    ("seeded_quadratic_fused", "ipb_gauss", "quadratic_fused", np.inf, None, "euler"),
    ("seeded_off_ipb", "ipb_bern", "off", np.inf, None, "euler"),
]
TRAIN_SEED = 3


def _case_noise(case):
    key, name, fast_path, _, noise, _ = case
    if noise == "jax":
        return _jax_train_noise(fast_path)
    return None if noise is None else _train_noise(name)


def _x_test():
    return np.linspace(-2.5, 2.5, 60)[:, None]  # 8 blocks of 8, the last padded by 4


PREDICT_CASES = [("predict_onb", "onb_gauss", None), ("predict_ipb", "ipb_gauss", None),
                 ("predict_onb_student_t", "onb_gauss", 3.0)]


def _jobs_four():
    jobs = [{"kind": "mesh"}]
    for name in ("onb_gauss", "ipb_bern"):
        for shape in MESHES:
            jobs.append({"kind": "steps_noise", "key": ("steps", name, shape), "model": name,
                         "mesh": shape, "noise": _step_noise(name), "eta": ETA})
    for name in NO_CLOSED_FORM:
        jobs.append({"kind": "steps_noise", "key": ("steps", name, (2, 2)), "model": name,
                     "mesh": (2, 2), "noise": _step_noise(name), "eta": ETA})
    for name in ("onb_gauss", "ipb_gauss"):
        jobs.append({"kind": "steps_energy", "key": ("energy", name), "model": name,
                     "mesh": (2, 2), "seed": 0, "eta": ETA, "steps": 3})
    for case in TRAIN_CASES:
        key, name, fast_path, patience, noise, disc = case
        jobs.append({"kind": "train", "key": key, "model": name, "mesh": (1, 4),
                     "fast_path": fast_path, "patience": patience, "steps": TRAIN_STEPS,
                     "eta": ETA, "discretisation": disc, "noise": _case_noise(case),
                     "seed": TRAIN_SEED if noise is None else None})
    for key, name, df in PREDICT_CASES:
        jobs.append({"kind": "predict", "key": key, "model": name, "mesh": (1, 4),
                     "x_test": _x_test(), "chunk": 8, "seed": 5, "extra_df": df})
    return jobs


def _jobs_two():
    jobs = [{"kind": "mesh"}]
    for shape in ((2, 1), (1, 2)):
        jobs.append({"kind": "steps_noise", "key": ("steps", "onb_gauss", shape),
                     "model": "onb_gauss", "mesh": shape, "noise": _step_noise("onb_gauss"),
                     "eta": ETA})
    case = TRAIN_CASES[1]  # the off tier, stopping mid-run
    jobs.append({"kind": "train", "key": case[0], "model": case[1], "mesh": (1, 2),
                 "fast_path": case[2], "patience": case[3], "steps": TRAIN_STEPS, "eta": ETA,
                 "discretisation": case[5], "noise": _case_noise(case), "seed": None})
    return jobs


def _spawn(directory, world, jobs):
    """Run ``world`` ranks of the worker on ``jobs``; returns each rank's
    results."""
    models = sorted({job["model"] for job in jobs if "model" in job})
    task = os.path.join(directory, "task.pkl")
    with open(task, "wb") as f:
        pickle.dump({"models": {name: _spec(name) for name in models}, "jobs": jobs}, f)
    env = dict(os.environ)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(world), os.path.join(directory, "init"),
             task, directory],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{out}"
    results = []
    for rank in range(world):
        with open(os.path.join(directory, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("four_ranks")), 4, _jobs_four())


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("two_ranks")), 2, _jobs_two())


def _jax_steps(name, shape):
    jbasis, jcost, _, _, u0 = _models()[name]
    mesh = jmake_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
    return np.asarray(j_steps_with_noise(mesh, jbasis, jcost, jnp.asarray(u0),
                                         jnp.asarray(_step_noise(name)), ETA))


def _single_train(case, steps=TRAIN_STEPS):
    """The port's single-device run of a case, as train_pls routes it."""
    key, name, fast_path, patience, noise, disc = case
    _, _, basis, cost, u0 = _models()[name]
    u = torch.as_tensor(u0)
    exit_map = None
    if ttrain.needs_w_space_reroute(basis, fast_path, disc):
        basis, s_mat, s_inv = ttrain.ipb_w_space_view(basis)
        u = s_inv @ u
        exit_map = lambda v: s_mat @ v  # noqa: E731
    tier = ttrain.resolve_tier(basis, cost, fast_path, disc)
    spec = ttrain.spectral_system_host(basis, cost, disc) if tier == "spectral" else None
    noise = _case_noise(case)
    res = ttrain._train_pls_loop(
        basis, cost, u, ETA, patience, steps, tier, spec,
        generator=TRAIN_SEED if noise is None else None,
        noise=None if noise is None else torch.as_tensor(noise), discretisation=disc)
    return res if exit_map is None else res._replace(particles=exit_map(res.particles))


def _assert_train_equal(got, expected, case):
    particles, energies, recorded, steps_run = got
    np.testing.assert_allclose(particles, to_np(expected.particles), rtol=RTOL, atol=1e-12,
                               err_msg=case[0])
    np.testing.assert_allclose(energies, to_np(expected.energies), rtol=RTOL, err_msg=case[0])
    np.testing.assert_array_equal(recorded, to_np(expected.recorded), err_msg=case[0])
    assert int(steps_run) == int(expected.steps_run), case[0]


# --- the four-rank run ---------------------------------------------------------
def test_ranks_join_once_and_idempotently(four):
    for rank, res in enumerate(four):
        assert res["joined"] == (rank, 4) and res["again"] == (rank, 4)


def test_make_mesh_defaults_and_assertion(four):
    assert four[0]["mesh"] == {"default": (1, 4), "n_data=2": (2, 2), "n_particles=1": (4, 1),
                               "bad": "mesh 5x1 != 4 devices"}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["onb_gauss", "ipb_bern"])
def test_steps_with_noise_match_jax(four, name, shape):
    expected = _jax_steps(name, shape)
    for res in four:  # every rank returns the whole matrix
        np.testing.assert_allclose(res[("steps", name, shape)], expected, rtol=RTOL, atol=1e-11)


@pytest.mark.parametrize("name", NO_CLOSED_FORM)
def test_steps_with_noise_of_a_cost_with_no_closed_form_match_jax(four, name):
    """The probit link and the smoothed Bernoulli have no closed form in B5:
    the plain drift on each data rank's rows (the smoothing stds cut with
    them), summed over "data"."""
    np.testing.assert_allclose(four[0][("steps", name, (2, 2))], _jax_steps(name, (2, 2)),
                               rtol=RTOL, atol=1e-11)


@pytest.mark.parametrize("name", ["onb_gauss", "ipb_gauss"])
def test_sharded_energy_matches_the_single_device_definition(four, name):
    """The energies summed over both axes equal the facade's energy of the
    gathered particles (JAX test_parallel.py:125, :175); data ranks of one
    column shard draw the same noise, so every rank holds the same U."""
    _, _, tbasis, tcost, _ = _models()[name]
    final, energies = four[0][("energy", name)]
    assert energies.shape == (3,) and np.all(np.isfinite(energies))
    expected = float(TPLS(tbasis, tcost).calculate_energy_potential(torch.as_tensor(final)))
    assert float(energies[-1]) == pytest.approx(expected, rel=RTOL)
    for res in four[1:]:
        np.testing.assert_array_equal(res[("energy", name)][0], final)
        np.testing.assert_array_equal(res[("energy", name)][1], energies)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c[0])
def test_parallel_train_matches_the_single_device_trainer(four, case):
    expected = _single_train(case)
    if case[3] < np.inf:
        assert int(expected.steps_run) < TRAIN_STEPS, "the finite patience did not stop"
    for res in four:
        _assert_train_equal(res[case[0]], expected, case)


@pytest.mark.parametrize("tier", JAX_NOISE_TIERS)
def test_parallel_train_matches_jax_parallel_train(four, tier):
    case = next(c for c in TRAIN_CASES if c[2] == tier and c[4] == "jax")
    jbasis, jcost, _, _, u0 = _models()["onb_gauss"]
    expected = j_parallel_train_pls(
        jmake_mesh(1, 4, devices=jax.devices()[:4]), JPLS(jbasis, jcost),
        particles=jnp.asarray(u0), number_of_epochs=TRAIN_STEPS, step_size=ETA,
        early_stopper_patience=case[3], key=as_key(123), fast_path=tier)
    _assert_train_equal(four[0][case[0]], expected, case)


@pytest.mark.parametrize("case", PREDICT_CASES, ids=lambda c: c[0])
def test_mesh_predict_matches_the_single_device_chunked_draws(four, case):
    key, name, df = case
    _, _, tbasis, tcost, u0 = _models()[name]
    if df is not None:
        from projected_langevin_sampling_torch.models.basis.noise_distributions import (
            StudentTPredictiveNoise,
        )

        tbasis = tbasis.replace(
            additional_predictive_noise_distribution=StudentTPredictiveNoise(df=df, scale=0.1))
    expected = TPLS(tbasis, tcost).predict_samples(
        torch.as_tensor(u0), torch.as_tensor(_x_test()), generator=5, chunk_size=8)
    for res in four:
        np.testing.assert_allclose(res[key], to_np(expected), rtol=PREDICT_RTOL, atol=1e-12)


# --- the two-process run ---------------------------------------------------------
def test_two_process_run(two):
    """JAX test_multihost.py:32's run: two processes join, idempotently, and
    the sharded chain over a mesh whose data or particle axis spans both is
    the single-device chain; training stops where the single device does."""
    for rank, res in enumerate(two):
        assert res["joined"] == (rank, 2) and res["again"] == (rank, 2)
        assert res["mesh"] == {"default": (1, 2), "n_data=2": (2, 1), "n_particles=1": (2, 1),
                               "bad": "mesh 3x1 != 2 devices"}
        for shape in ((2, 1), (1, 2)):
            np.testing.assert_allclose(res[("steps", "onb_gauss", shape)],
                                       _jax_steps("onb_gauss", (1, 1)), rtol=RTOL, atol=1e-11)
        _assert_train_equal(res[TRAIN_CASES[1][0]], _single_train(TRAIN_CASES[1]),
                            TRAIN_CASES[1])


# --- in this process ---------------------------------------------------------------
def test_initialize_multi_host_is_a_no_op_with_nothing_to_coordinate(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    assert initialize_multi_host(device="cpu") == (0, 1)
    assert not dist.is_initialized()


def test_make_mesh_of_a_lone_process_is_one_by_one():
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "particles")
        with pytest.raises(AssertionError, match="mesh 2x1 != 1 devices"):
            make_mesh(2, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_column_and_row_shards():
    # shards of ceil(J / n) columns rounded up to a multiple of 4
    assert [particle_columns(1000, 4, i) for i in range(4)] == [
        (0, 252), (252, 252), (504, 252), (756, 244)]
    assert [particle_columns(16, 4, i) for i in range(4)] == [(0, 4), (4, 4), (8, 4), (12, 4)]
    assert [data_rows(10, 3, i) for i in range(3)] == [(0, 4), (4, 4), (8, 2)]
    with pytest.raises(ValueError, match="empty"):
        particle_columns(8, 4, 2)


def test_mirror_noise_of_a_shard_is_its_columns_of_the_run():
    whole = tspec.mirror_noise(7, 3, 16, 2)
    for j0 in (0, 8):
        np.testing.assert_array_equal(
            tspec.mirror_noise(7, 3, 8, 2, j0=j0, j_total=16), whole[:, :, j0:j0 + 8])


def _b1(u0, generator, shard, patience=np.inf, steps=20):
    m = u0.shape[0]
    rng = np.random.default_rng(1)
    c = [torch.as_tensor(v) for v in (rng.uniform(0.9, 0.99, m), rng.normal(size=m) * 1e-2,
                                      rng.uniform(1, 2, m), rng.normal(size=m))]
    return tspec.spectral_train(u0, *c, eta=ETA, patience=patience, e_const=3.5,
                                num_steps=steps, noise_scale=0.05, generator=generator,
                                shard=shard)


def _b3(u0, generator, shard, patience=np.inf, steps=20):
    rng = np.random.default_rng(2)
    n, m = 20, u0.shape[0]
    p = torch.as_tensor(rng.normal(size=(n, m)) / np.sqrt(m))
    y = torch.as_tensor((rng.uniform(size=n) > 0.5).astype(np.float64))
    lam = torch.as_tensor(rng.uniform(0.5, 2.0, m))
    return tgen.general_train(p, u0, y, lam, "bernoulli_sigmoid", eta=ETA, patience=patience,
                              num_steps=steps, generator=generator, shard=shard)


def _b4(u0, generator, shard, patience=np.inf, steps=20):
    rng = np.random.default_rng(3)
    m = u0.shape[0]
    g = rng.normal(size=(m, m))
    a = torch.as_tensor(g @ g.T / m + np.eye(m))
    s = torch.as_tensor(np.linalg.cholesky(np.asarray(a)))
    b, e_bias = (torch.as_tensor(rng.normal(size=m)) for _ in range(2))
    return tquad.quadratic_train(a, b, a + 0.5 * torch.eye(m, dtype=a.dtype), e_bias, s, u0,
                                 eta=ETA, patience=patience, e_const=2.25, num_steps=steps,
                                 shared=False, generator=generator, shard=shard)


@pytest.mark.parametrize("run", [_b1, _b3, _b4], ids=["B1", "B3", "B4"])
def test_plain_kernel_on_column_shards_is_the_whole_run(run):
    """Two column shards, each on the same generator state, are the whole
    run's columns (the shard keeps its columns of the whole draw), and their
    energies are shares that sum to the whole run's."""
    u0 = torch.as_tensor(np.random.default_rng(0).normal(size=(6, J)))
    whole = run(u0, as_generator(9, device="cpu"), None)
    shards = [run(u0[:, j0:j0 + 8], as_generator(9, device="cpu"), ColumnShard(j0, J))
              for j0 in (0, 8)]
    np.testing.assert_allclose(to_np(torch.cat([s[0] for s in shards], dim=1)), to_np(whole[0]),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(to_np(shards[0][1] + shards[1][1]), to_np(whole[1]), rtol=1e-12)


GLOBAL_STOP_STEPS = 60


@pytest.mark.parametrize("run", [_b1, _b3, _b4], ids=["B1", "B3", "B4"])
def test_global_stop_of_column_shards_is_the_whole_runs_stop(run):
    """``parallel/auto.train_to_global_stop`` on two column shards of the
    plain kernels, each rank's all-reduce played by adding the other shard's
    trace, at a patience that stops the run mid-way: the whole run's stop,
    energies, recorded flags and particles (after one rerun to the stop)."""
    u0 = torch.as_tensor(np.random.default_rng(0).normal(size=(6, J)))
    steps = GLOBAL_STOP_STEPS
    trace = run(u0, as_generator(9, device="cpu"), None, steps=steps)[1]
    # (k + 1/2) steps: a patience off the boundary sim_time = patience
    stops = {k: int(replay_early_stopper(trace, ETA, (k + 0.5) * ETA)[1]) for k in (1, 2, 4, 8)}
    k = next((k for k, stop in stops.items() if 2 <= stop < steps), None)
    assert k is not None, f"no patience stops the run mid-way: {stops}"
    patience = (k + 0.5) * ETA
    whole = run(u0, as_generator(9, device="cpu"), None, patience=patience, steps=steps)

    def shard_run(j0):
        return lambda n: ttrain.TrainResult(*run(u0[:, j0:j0 + 8], as_generator(9, device="cpu"),
                                                 ColumnShard(j0, J), steps=n))

    shares = [shard_run(j0)(steps).energies for j0 in (0, 8)]
    got = [tauto.train_to_global_stop(shard_run(j0), steps, ETA, patience,
                                      lambda e, other=shares[1 - i]: e + other)
           for i, j0 in enumerate((0, 8))]
    for res in got:
        assert int(res.steps_run) == int(whole[3]) < steps
        np.testing.assert_array_equal(to_np(res.recorded), to_np(whole[2]))
        np.testing.assert_allclose(to_np(res.energies), to_np(whole[1]), rtol=1e-12)
    np.testing.assert_allclose(to_np(torch.cat([r.particles for r in got], dim=1)),
                               to_np(whole[0]), rtol=1e-12, atol=1e-14)


def test_spectral_tier_on_several_particle_ranks_needs_j_a_multiple_of_4(monkeypatch):
    """The card's B1 draws whole Philox groups of four elements, so the CPU
    refuses what the card would: J = 10 on two particle ranks."""
    monkeypatch.setattr(tauto, "axis", lambda mesh, name: (None, 2, 0))
    _, _, basis, cost, u0 = _models()["onb_gauss"]
    with pytest.raises(ValueError, match="multiple of 4"):
        tauto.parallel_train_pls(None, basis, cost, particles=torch.as_tensor(u0[:, :10]),
                                 number_of_epochs=3, step_size=ETA, fast_path="spectral")


def _emulated_b1_launch(w0, w_out, coeffs, partials, j, j0, j_total, step0, num_steps,
                        noise_scale, seed, zero_noise):
    """B1's zero-noise arithmetic and layout on the CPU: element e of the
    flattened particles in block e // (THREADS x ELEMENTS_PER_THREAD), whose
    energy of step s goes to partials[block, s]."""
    decay, shift, sigma, b = coeffs
    element = torch.arange(w0.numel())
    rows, blocks = element // j, element // (tspec.THREADS * tspec.ELEMENTS_PER_THREAD)
    w = w0.reshape(-1).clone()
    for s in range(num_steps):
        w = decay[rows] * w + shift[rows]
        energy = 0.5 * sigma[rows] * w * w - b[rows] * w
        partials[:, s] = torch.zeros(partials.shape[0], dtype=partials.dtype).index_add_(
            0, blocks, energy)
    w_out.copy_(w.reshape(w0.shape))


def test_b1_wrapper_energies_of_column_shards_are_the_whole_run(monkeypatch):
    """B1's launches in its wrapper on column shards, with the kernel's
    arithmetic emulated: each shard's energies are its share, the constant's
    share included, and the shards' energies summed are the whole run's (the
    sum the particle ranks' all-reduce makes in ``parallel/auto.py``)."""
    monkeypatch.setattr(tspec, "_launch", _emulated_b1_launch)
    rng = np.random.default_rng(6)
    m, j_total, steps, e_const = 8, 1024, 5, 12.5  # 4 blocks of 2048 elements
    w0 = torch.as_tensor(rng.normal(size=(m, j_total)), dtype=torch.float32)
    coeffs = [torch.as_tensor(v, dtype=torch.float32) for v in (
        rng.uniform(0.9, 0.99, m), rng.normal(size=m), rng.uniform(1, 2, m), rng.normal(size=m))]
    run = lambda w, j, shard: tspec._run_kernel(  # noqa: E731
        w.contiguous(), coeffs, j, steps, 0.1, 0, True, e_const, shard=shard)
    whole_w, whole_e = run(w0, j_total, None)
    other_w, other_e = run(w0[:, 512:], 512, ColumnShard(512, j_total))
    first_w, first_e = run(w0[:, :512], 512, ColumnShard(0, j_total))
    np.testing.assert_allclose(to_np(torch.cat([first_w, other_w], dim=1)), to_np(whole_w),
                               rtol=1e-6)
    np.testing.assert_allclose(to_np(first_e + other_e), to_np(whole_e), rtol=1e-5)


@pytest.mark.parametrize("prior_kind", ["diagonal", "matrix"])
def test_b5_partial_mode_summed_over_row_shards_is_the_fused_step(prior_kind):
    rng = np.random.default_rng(4)
    n, m = 30, 6
    p, d = (torch.as_tensor(rng.normal(size=(n, m))) for _ in range(2))
    u, noise = (torch.as_tensor(rng.normal(size=(m, J))) for _ in range(2))
    y = torch.as_tensor((rng.uniform(size=n) > 0.5).astype(np.float64))
    g = rng.normal(size=(m, m))
    prior = torch.as_tensor(rng.uniform(1, 2, m) if prior_kind == "diagonal" else g @ g.T)
    kw = dict(params=(1e-10, 0.0), mean_shift=0.3)
    fused = tfused.fused_update(p, d, y, u, prior, noise, "bernoulli_sigmoid", eta=ETA, **kw)
    drift = sum(tfused.fused_drift(p[r], d[r], y[r], u, "bernoulli_sigmoid", **kw)
                for r in (slice(0, 13), slice(13, n)))
    np.testing.assert_allclose(to_np(tfused.apply_drift(u, drift, prior, noise, ETA)),
                               to_np(fused), rtol=1e-12, atol=1e-14)
