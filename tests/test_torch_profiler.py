"""The port's profiler (``experiments_torch/profiler/main.py``) against the
JAX harness's on the CPU: the problem it times, built from the same inputs
(y carried across, fp64) to rtol 1e-10 (the ONB's eigh and projection are
host fp64 in both packages), and a sweep of two values an axis and one
seed that writes the JAX profiler's CSVs: the same files, columns and
rows, with positive finite times."""

import contextlib
import csv
import io
import math

import jax.numpy as jnp
import numpy as np
import torch

from experiments.profiler import main as jprofiler
from experiments_torch.config import load_config
from experiments_torch.profiler import main as tprofiler
from tests.torch_parity import to_np


def _config():
    config = load_config("experiments_torch/profiler/config_short.yaml")
    for axis in tprofiler.AXES:
        # two values an axis, the first two of the sweep
        config[axis]["stop"] = config[axis]["start"] + config[axis]["step"]
    return config


def test_make_problem_matches_jax():
    jbasis, jcost, jkernel, jz = jprofiler._make_problem(150, 12, seed=3, dtype=jnp.float64)
    tbasis, tcost, tkernel, tz = tprofiler._make_problem(
        150, 12, seed=3, device="cpu", dtype=torch.float64, y=np.array(jcost.y_train))
    np.testing.assert_array_equal(to_np(tkernel.approximation_samples),
                                  np.asarray(jkernel.approximation_samples))
    np.testing.assert_array_equal(to_np(tz), np.asarray(jz))
    for name in ("eigenvalues", "scaled_eigenvectors", "train_projection"):
        np.testing.assert_allclose(to_np(getattr(tbasis, name)), np.asarray(getattr(jbasis, name)),
                                   rtol=1e-10, atol=1e-12)
    assert float(tcost.observation_noise) == float(jcost.observation_noise) == 1.0
    # the port's own draw: Curve2 with sigma 0.2 at the sorted inputs
    _, own, _, _ = tprofiler._make_problem(150, 12, seed=3, device="cpu", dtype=torch.float64)
    residual = own.y_train - tprofiler.Curve2().calculate_curve(
        tkernel.approximation_samples).reshape(-1)
    assert abs(float(residual.std()) - 0.2) < 4 * 0.2 / math.sqrt(2 * 150)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_sweep_writes_the_jax_profilers_csvs(tmp_path, monkeypatch):
    config = _config()
    monkeypatch.setattr(jprofiler, "_plot_sweep", lambda *a, **k: None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jprofiler.run_sweeps(config, str(tmp_path / "jax"), "auto")
        sweeps = tprofiler.run_sweeps(config, str(tmp_path / "torch"), "auto", device="cpu")
    assert set(sweeps) == set(tprofiler.AXES) == {
        "number_of_data_points", "number_of_induce_points", "number_of_epochs",
        "number_of_particles"}
    for axis in tprofiler.AXES:
        jrows, trows = _rows(tmp_path / "jax" / f"{axis}.csv"), _rows(tmp_path / "torch" / f"{axis}.csv")
        assert trows[0] == jrows[0] == tprofiler.COLUMNS
        # pls and svgp rows of two values (pls only on the particle axis)
        assert len(trows) == len(jrows) == 1 + (2 if axis == "number_of_particles" else 4)
        for trow, jrow in zip(trows[1:], jrows[1:]):
            assert trow[:4] == jrow[:4]
            assert math.isfinite(float(trow[4])) and float(trow[4]) > 0
    # every PLS row ran the spectral tier ("auto" for a Gaussian-identity cost)
    pls_lines = [line for line in out.getvalue().splitlines() if " pls " in line]
    assert len(pls_lines) == 8 and all("(spectral tier)" in line for line in pls_lines)
