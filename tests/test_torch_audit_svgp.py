"""The port's ``experiments_torch/audit_svgp.py`` against the JAX script
(``experiments/audit_svgp.py``), on the CPU in fp64.

The JAX script's ``run_audit`` runs once on synthetic ``energy_cooling`` (200
rows, the JAX generator's), seed 0, with ``config_precond_map.yaml`` cut in
depth (2 subsample GPs of 30 epochs on 100 rows, two SVGP learning rates of
20 epochs), recording what its ``_setup`` returns. Both sides get those
outputs as numpy:

- the port's copy of the plain-torch rebuild (``rebuild_svgp``) gives the
  JAX script's torch column (NLL, MSE, learned noise) at rtol 1e-12: the
  same code on the same inputs;
- the port's harness SVGP (``harness_svgp``, ``train_svgp_runner``) gives
  the JAX harness's column at rtol 1e-8, the harness's SVGP tolerance.

The port's own ``setup`` on the same CSV (the port's generator writes the
same bytes) matches the JAX ``_setup`` at 1e-8, and the port's whole audit
writes its report.
"""

import contextlib
import io
import math
import os

import numpy as np
import pytest
import torch
import yaml

from experiments import audit_svgp as jaudit
from experiments import plotters as jplotters
from experiments.uci import make_synthetic_datasets as jsynthetic
from experiments_torch import audit_svgp as taudit
from experiments_torch.config import load_config
from experiments_torch.data import Data, ExperimentData, ProblemType
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from tests.torch_parity import one_thread, to_np

CONFIG = "experiments/uci/regression/config_precond_map.yaml"
CUTS = {"kernel": dict(number_of_iterations=2, number_of_epochs=30, subsample_size=100),
        "svgp": dict(number_of_learning_rate_searches=2, number_of_epochs=20)}
ROWS, REBUILD_RTOL, HARNESS_RTOL = 200, 1e-12, 1e-8


def _cut(cfg):
    for section, values in CUTS.items():
        cfg[section].update(values)
    return cfg


@pytest.fixture(scope="module")
def jax_audit(tmp_path_factory):
    root = tmp_path_factory.mktemp("audit_svgp")
    datasets = root / "experiments" / "uci" / "datasets"
    with open(CONFIG) as f:
        cfg = _cut(yaml.safe_load(f))
    setups = []
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        jsynthetic.main(ROWS, str(datasets))
        mp.setattr(jplotters, "plot_losses", lambda *a, **k: None)
        mp.setattr(jaudit, "_setup", lambda *a, _fn=jaudit._setup, **k: setups.append(
            _fn(*a, **k)) or setups[-1])
        try:
            os.chdir(root)  # the JAX main reads experiments/uci/datasets from here
            rows = jaudit.run_audit(["energy_cooling"], [0], cfg, str(root / "jax"))
        finally:
            os.chdir(cwd)
    return root, cfg, setups[0], rows[0]


def _port_inputs(setup):
    """The JAX ``_setup``'s outputs as the port's, fp64 on the CPU."""
    experiment_data, inducing_points, pls_kernel, noise0, mean0 = setup

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a, dtype=np.float64))

    def part(d):
        return None if d is None else Data(x=t(d.x), y=t(d.y), name=d.name)

    data = ExperimentData(name=experiment_data.name, problem_type=ProblemType.REGRESSION,
                          full=part(experiment_data.full), train=part(experiment_data.train),
                          test=part(experiment_data.test),
                          validation=part(experiment_data.validation))
    base = pls_kernel.base_kernel
    kernel = PLSKernel(base_kernel=ARDKernel(lengthscales=t(base.lengthscales),
                                             outputscale=t(base.outputscale)),
                       approximation_samples=t(pls_kernel.approximation_samples))
    return data, Data(x=t(inducing_points.x), y=t(inducing_points.y), name="induce"), kernel, \
        noise0, mean0


def test_rebuild_matches_the_jax_scripts_torch_column(jax_audit):
    _, cfg, setup, row = jax_audit
    params, nll, mse = taudit.rebuild_svgp(*_port_inputs(setup), cfg["svgp"])
    assert nll == pytest.approx(row["torch_nll"], rel=REBUILD_RTOL)
    assert mse == pytest.approx(row["torch_mse"], rel=REBUILD_RTOL)
    assert params["noise"] == pytest.approx(row["torch_noise"], rel=REBUILD_RTOL)


def test_harness_svgp_matches_the_jax_harness_column(jax_audit, tmp_path):
    _, cfg, setup, row = jax_audit
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        svgp, nll, mse = taudit.harness_svgp(*_port_inputs(setup), cfg["svgp"],
                                             str(tmp_path / "svgp-audit"))
    assert nll == pytest.approx(row["jax_nll"], rel=HARNESS_RTOL)
    assert mse == pytest.approx(row["jax_mse"], rel=HARNESS_RTOL)
    assert float(svgp.likelihood.noise) == pytest.approx(row["jax_noise"], rel=HARNESS_RTOL)


def test_port_setup_and_audit_match_the_jax_setup(jax_audit, tmp_path):
    root, _, setup, row = jax_audit
    cfg = _cut(load_config(CONFIG))
    datasets = str(root / "experiments" / "uci" / "datasets")
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        data, inducing_points, kernel, noise0, mean0 = taudit.setup(
            "energy_cooling", 0, cfg, str(tmp_path / "port"), datasets, device="cpu")
        rows = taudit.run_audit(["energy_cooling"], [0], cfg, str(tmp_path / "port"), datasets,
                                device="cpu")
    jdata, jinducing, jkernel, jnoise0, jmean0 = setup
    # pandas' float parser, which the JAX main reads the CSV with, may land an
    # ulp from the value the text names (the port's reads round-trip)
    np.testing.assert_allclose(to_np(data.train.x), to_np(jdata.train.x), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(to_np(inducing_points.x), to_np(jinducing.x), rtol=1e-15,
                               atol=1e-15)
    np.testing.assert_allclose(to_np(kernel.base_kernel.lengthscales),
                               to_np(jkernel.base_kernel.lengthscales), rtol=1e-8)
    assert (noise0, mean0) == (pytest.approx(jnoise0, rel=1e-8),
                               pytest.approx(jmean0, rel=1e-8, abs=1e-12))
    (port_row,) = rows
    assert port_row["harness_nll"] == pytest.approx(row["jax_nll"], rel=HARNESS_RTOL)
    assert port_row["rebuild_nll"] == pytest.approx(row["torch_nll"], rel=HARNESS_RTOL)
    # the second run loads the cached data, GP fits and inducing points
    assert os.path.exists(tmp_path / "port" / "0" / "data" / "energy_cooling" /
                          "inducing_points.pkl")


def test_report_renders_the_rows(tmp_path):
    rows = [dict(dataset="boston", seed=0, noise_init=0.009, harness_nll=0.8468,
                 rebuild_nll=0.8439, harness_mse=0.317, rebuild_mse=0.3151, harness_noise=0.2862,
                 rebuild_noise=0.2844),
            dict(dataset="boston", seed=1, noise_init=0.009, harness_nll=1.0009,
                 rebuild_nll=0.9981, harness_mse=0.4326, rebuild_mse=0.4302,
                 harness_noise=0.4068, rebuild_noise=0.4041)]
    text = taudit.render(rows)
    assert "| boston | 1 | 0.0090 | 1.0009 | 0.9981 | 0.4326 | 0.4302 | 0.4068 | 0.4041 |" in text
    assert "Mean NLL delta (harness - rebuild): +0.0028 (max |delta| 0.0029 over 2 runs)." in text
    assert not math.isnan(float(text.split("delta (harness - rebuild): ")[1].split()[0]))
