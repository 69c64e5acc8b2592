"""The port's ``experiments_torch/compare_onb_scaling.py`` against the JAX
script (``experiments/compare_onb_scaling.py``), on the CPU in fp64.

The JAX script's ``run_curve`` runs once on curve 2 (120 data points, its
config with the script's overrides, cut in depth: one exact GP of 10
epochs, three step-size candidates of at most 10,000 steps, two SVGP
learning rates of 5 epochs), recording its data, kernel, inducing points,
bases and trained particles. Then:

- the port's ``scaling_basis`` on the same kernel and inducing points
  builds both scalings' bases at rtol 1e-10, the build tolerance (the
  sign-invariant products, normwise as ``tests/test_torch_basis.py``);
- the port's PLS on that basis, given the JAX run's trained particles and
  the noise JAX's ``predict(key=0)`` draws, scores the JAX row's test MSE
  and NLL at rtol 1e-7, as ``test_port_models_on_the_jax_particles_match_jax``
  holds the curve mains;
- given the same rows, the port renders the JAX script's table text, and
  its counts read the reference record's table
  (``results/onb_scaling_comparison.md``): nystrom beats reference on NLL on
  9 of 10 curves (the record's summary says 10/10, but its curve1 row has
  4.0465 against 2.0684), on MSE on 7, and both beat the SVGP's NLL on 10;
- the port's own ``run`` on one curve writes a finite row.
"""

import builtins
import contextlib
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from experiments import compare_onb_scaling as jcompare
from experiments_torch import compare_onb_scaling as tcompare
from experiments_torch.config import load_config
from projected_langevin_sampling_torch.convert import pls_kernel_from_numpy
from projected_langevin_sampling_torch.models.costs import GaussianCost
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_tpu.utils.prng import as_key
from tests.torch_parity import basis_params_kernel, one_thread, to_np

BUILD_RTOL, METRIC_RTOL = 1e-10, 1e-7
CURVE = 2


def _cut(cfg):
    cfg["data"]["number_of_data_points"] = 120
    cfg["kernel"].update(number_of_epochs=10, number_of_iterations=1)
    cfg["pls"].update(number_of_step_searches=3, maximum_number_of_steps=1e4)
    cfg["svgp"].update(number_of_epochs=5, number_of_learning_rate_searches=2)
    return cfg


def _jax_config():
    with open("experiments/curves/regression/config.yaml") as f:
        cfg = yaml.safe_load(f)
    # the overrides of the JAX script's main (compare_onb_scaling.py:177-179)
    cfg["pls"].update(number_of_step_searches=6, simulation_duration=1.0,
                      maximum_number_of_steps=1e6)
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    record = {"bases": {}, "trained": {}}
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        def data(*a, _fn=jcompare.get_experiment_data, **k):
            record["data"] = _fn(*a, **k)
            return record["data"]

        def build(*a, _fn=jcompare.build_orthonormal_basis, **k):
            basis = _fn(*a, **k)
            record["bases"][k["scaling"]] = (basis, k)
            return basis

        def train(*a, _fn=jcompare.train_pls_runner, **k):
            out = _fn(*a, **k)
            record["trained"][k["particle_name"].rsplit("-", 1)[1]] = (k["pls"], out[0])
            return out

        mp.setattr(jcompare, "get_experiment_data", data)
        mp.setattr(jcompare, "build_orthonormal_basis", build)
        mp.setattr(jcompare, "train_pls_runner", train)
        row = jcompare.run_curve(jcompare.CURVE_FUNCTIONS[CURVE - 1], _cut(_jax_config()),
                                 str(tmp_path_factory.mktemp("jax_onb")))
    record["row"] = row
    return record


def _port_basis(jax_run, scaling):
    jbasis, kwargs = jax_run["bases"][scaling]
    kernel = pls_kernel_from_numpy(basis_params_kernel(kwargs["kernel"]), device="cpu")
    return tcompare.scaling_basis(kernel, torch.from_numpy(np.array(kwargs["x_induce"])),
                                  torch.from_numpy(np.array(kwargs["x_train"])), scaling)


def _invariants(basis):
    vt, lam = to_np(basis.scaled_eigenvectors), to_np(basis.eigenvalues)
    b, k_zx = to_np(basis.train_projection), to_np(basis.base_gram_induce_train)
    u = np.random.default_rng(1).normal(size=(vt.shape[1], 5))
    return {"eigenvalues": lam, "vt_lam_vt": (vt * lam) @ vt.T, "b_bt": b @ b.T,
            "kzx_vt_u": k_zx.T @ vt @ u}


@pytest.mark.parametrize("scaling", tcompare.SCALINGS)
def test_bases_match_jax(jax_run, scaling):
    jbasis, kwargs = jax_run["bases"][scaling]
    assert kwargs["relative_eigenvalue_threshold"] == (1e-5 if scaling == "nystrom" else None)
    tbasis = _port_basis(jax_run, scaling)
    assert tbasis.scaling == scaling
    assert tbasis.approximation_dimension == jbasis.approximation_dimension
    got, expected = _invariants(tbasis), _invariants(jbasis)
    for name in expected:
        np.testing.assert_allclose(got[name], expected[name], rtol=BUILD_RTOL,
                                   atol=BUILD_RTOL * np.abs(expected[name]).max(), err_msg=name)


@pytest.mark.parametrize("scaling", tcompare.SCALINGS)
def test_metrics_on_the_jax_particles_match_jax(jax_run, scaling):
    jpls, jparticles = jax_run["trained"][scaling]
    test = jax_run["data"].test
    # the noise JAX's predict(key=0) draws (PLS.predict_samples)
    key_pred, key_obs = jax.random.split(as_key(0))
    noise = jpls.basis.sample_predictive_noise(particles=jparticles, x=test.x, key=key_pred)
    obs = jpls.cost.sample_observation_noise(number_of_particles=jparticles.shape[1],
                                             key=key_obs, dtype=jnp.float64)
    jpred = jpls.predict(x=test.x, particles=jparticles, key=0)
    np.testing.assert_array_equal(
        np.asarray(jpls.predict(x=test.x, particles=jparticles, predictive_noise=noise,
                                observation_noise=obs).mean), np.asarray(jpred.mean))
    carried = lambda a: torch.from_numpy(np.array(a, dtype=np.float64))  # noqa: E731
    cost = GaussianCost(observation_noise=carried(jpls.cost.observation_noise),
                        y_train=carried(jpls.cost.y_train))
    tpls = PLS(basis=_port_basis(jax_run, scaling), cost=cost)
    mse, nll = tcompare.score(tpls, carried(jparticles),
                              type("Split", (), {"x": carried(test.x), "y": carried(test.y)}),
                              predictive_noise=carried(noise), observation_noise=carried(obs))
    row = jax_run["row"]
    assert mse == pytest.approx(row[f"{scaling}_mse"], rel=METRIC_RTOL)
    assert nll == pytest.approx(row[f"{scaling}_nll"], rel=METRIC_RTOL)


ROWS = [
    {"curve": "curve1", "reference_mse": 1.5841, "nystrom_mse": 4.84821, "svgp_mse": 3.0832,
     "reference_nll": 2.0684, "nystrom_nll": 4.04649, "svgp_nll": 29.43321},
    {"curve": "curve2", "reference_mse": 1.22674, "nystrom_mse": 1.14216,
     "reference_nll": 1.60044, "nystrom_nll": 1.26331},  # no SVGP candidate kept
]


def test_rendered_table_matches_the_jax_script(tmp_path):
    written = {}

    class Capture(io.StringIO):
        def __init__(self, path):
            super().__init__()
            self.path = path

        def close(self):
            written[self.path] = self.getvalue()
            super().close()

    def fake_open(path, mode="r", *a, **k):
        return Capture(path) if "w" in mode else builtins.open(path, mode, *a, **k)

    rows = iter([dict(r) for r in ROWS])
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jcompare, "open", fake_open, raising=False)
        mp.setattr(jcompare, "CURVE_FUNCTIONS", jcompare.CURVE_FUNCTIONS[:len(ROWS)])
        mp.setattr(jcompare, "run_curve", lambda *a, **k: next(rows))
        jcompare.main()
    (text,) = written.values()
    assert tcompare.render([dict(r) for r in ROWS]) == text


def test_counts_read_the_reference_record():
    rows = []
    with open("results/onb_scaling_comparison.md") as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if cells[0].startswith("curve") and cells[1][0].isdigit():
                rows.append(dict(zip(("curve",) + tcompare.COLUMNS,
                                     [cells[0]] + [float(c) for c in cells[1:]])))
    assert tcompare.counts(rows) == {"curves": 10, "nystrom_beats_reference_nll": 9,
                                     "nystrom_beats_reference_mse": 7, "both_beat_svgp_nll": 10}


def test_configs_are_the_jax_protocol_and_its_depth_cut():
    expected = _jax_config()
    assert tcompare.jax_protocol_config() == expected
    short = load_config("experiments_torch/config_onb_scaling_short.yaml")
    cuts = {(s, k) for s in expected for k in expected[s] if short[s][k] != expected[s][k]}
    assert cuts == {("kernel", "number_of_epochs"), ("svgp", "number_of_epochs")}


def test_port_run_writes_a_finite_row(tmp_path):
    cfg = _cut(load_config("experiments_torch/config_onb_scaling_short.yaml"))
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        rows = tcompare.run(cfg, [CURVE], device="cpu")
        assert tcompare.main(["--out", str(tmp_path / "t.md"), "--curves",
                              "--device", "cpu"]) == 1  # no curve asked, no row
    (row,) = rows
    assert row["curve"] == "curve2" and all(math.isfinite(row[c]) for c in tcompare.COLUMNS)
    assert (tmp_path / "t.md").read_text() == tcompare.render([])
    assert os.path.exists(tmp_path / "t.md")
