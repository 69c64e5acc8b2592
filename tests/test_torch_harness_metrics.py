"""The port harness's metrics against scikit-learn and the JAX harness, on
the CPU in fp64: accuracy, ROC AUC and F1 with ties; ``calculate_metrics``
on the same predictions (GP baselines and their calibration, built by the
JAX package and carried across with ``convert``) writes the same CSVs, and
``concatenate_metrics`` the same tables: values at rtol 1e-12, names, header
and index exactly."""

import csv
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics
import torch

from experiments import metrics as jmetrics
from experiments.data import Data as JData
from experiments.data import ExperimentData as JExperimentData
from experiments.data import ProblemType as JProblemType
from experiments_torch import metrics
from experiments_torch.data import Data, ExperimentData, ProblemType
from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_torch.models.conformalise import ConformaliseGP
from projected_langevin_sampling_torch.models.temper.gp import TemperGP
from projected_langevin_sampling_tpu.models import gaussian_process as jgp
from projected_langevin_sampling_tpu.models.conformalise import ConformaliseGP as JConformaliseGP
from projected_langevin_sampling_tpu.models.temper import TemperGP as JTemperGP
from tests.torch_parity import exact_gp_params, gp_jax_kernel, jax_svgp, svgp_params


def _labels_and_scores(kind, seed):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=200) < 0.4).astype(np.float64)
    if kind == "continuous":
        probs = rng.uniform(size=200)
    elif kind == "ties":  # scores on a coarse grid, ties inside and across classes
        probs = np.round(rng.uniform(size=200), 1)
    else:  # exact halves: probs.round() sends 0.5 to 0 (half to even)
        probs = rng.choice([0.25, 0.5, 0.75], size=200)
    return y, probs


@pytest.mark.parametrize("kind", ["continuous", "ties", "halves"])
@pytest.mark.parametrize("seed", [0, 1])
def test_acc_auc_f1_match_scikit_learn(kind, seed):
    y, probs = _labels_and_scores(kind, seed)
    t_probs, t_y = torch.as_tensor(probs), torch.as_tensor(y)
    assert metrics.calculate_acc(t_probs, t_y) == sklearn.metrics.accuracy_score(y, probs.round())
    np.testing.assert_allclose(metrics.calculate_auc(t_probs, t_y),
                               sklearn.metrics.roc_auc_score(y, probs), rtol=1e-12)
    np.testing.assert_allclose(metrics.calculate_f1(t_probs, t_y),
                               sklearn.metrics.f1_score(y, probs.round()), rtol=1e-12)


def test_f1_without_positives_and_auc_of_one_class():
    y = np.zeros(5)
    assert metrics.calculate_f1(np.full(5, 0.2), y) == 0.0
    with pytest.raises(ValueError):
        metrics.calculate_auc(np.linspace(0, 1, 5), y)


def _split(x, y, n_train, n_test):
    parts = {"train": slice(0, n_train), "test": slice(n_train, n_train + n_test),
             "validation": slice(n_train + n_test, None)}
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


def _models():
    """(name, JAX model, port model, JAX data, port data, dataset) cells
    covering every branch of ``calculate_metrics`` that is deterministic:
    Gaussian, tempered, conformal, Student-T and Bernoulli predictions."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (50, 2))
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.normal(size=50)
    exact = jgp.ExactGP(mean_constant=jnp.asarray(0.1), kernel=gp_jax_kernel(2),
                        noise=jnp.asarray(0.05), x_train=jnp.asarray(x[:20]),
                        y_train=jnp.asarray(y[:20]))
    t_exact = convert.exact_gp_from_numpy(exact_gp_params(exact), device="cpu")
    jdata, tdata = _split(x, y, 20, 15)
    cells = [("exact", exact, t_exact, jdata, tdata, "alpha")]
    cells.append(("exact-temper", JTemperGP(gp=exact, x_calibration=jdata.validation.x,
                                            y_calibration=jdata.validation.y),
                  TemperGP(gp=t_exact, x_calibration=tdata.validation.x,
                           y_calibration=tdata.validation.y), jdata, tdata, "alpha"))
    cells.append(("exact-conformalise",
                  JConformaliseGP(gp=exact, x_calibration=jdata.validation.x,
                                  y_calibration=jdata.validation.y),
                  ConformaliseGP(gp=t_exact, x_calibration=tdata.validation.x,
                                 y_calibration=tdata.validation.y), jdata, tdata, "alpha"))
    for likelihood in ("student_t", "bernoulli", "gaussian"):
        svgp, xs, ys = jax_svgp(likelihood, d=2)
        t_svgp = convert.svgp_from_numpy(svgp_params(svgp), device="cpu")
        xx = np.concatenate([xs, x[:20]])
        yy = np.concatenate([ys, (y[:20] > 0) if likelihood == "bernoulli" else y[:20]]).astype(float)
        jd, td = _split(xx, yy, 25, 15)
        cells.append((f"svgp-{likelihood}", svgp, t_svgp, jd, td, "beta"))
    return cells


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_table(ours, theirs):
    a, b = _read(ours), _read(theirs)
    assert len(a) == len(b) and a[0] == b[0]
    for row_a, row_b in zip(a[1:], b[1:]):
        assert row_a[0] == row_b[0] and len(row_a) == len(row_b)
        for va, vb in zip(row_a[1:], row_b[1:]):
            if vb == "":
                assert va == ""
            else:
                np.testing.assert_allclose(float(va), float(vb), rtol=1e-12)


def test_calculate_and_concatenate_metrics_write_the_jax_harness_tables(tmp_path):
    cells = _models()
    for name, jmodel, tmodel, jdata, tdata, dataset in cells:
        jmetrics.calculate_metrics(jmodel, jdata, name, dataset,
                                   str(tmp_path / "jax" / dataset), str(tmp_path / "plots"), 0.9)
        metrics.calculate_metrics(tmodel, tdata, name, dataset, str(tmp_path / "torch" / dataset),
                                  0.9)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    ours = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "torch")
                  for d, _, fs in os.walk(tmp_path / "torch") for f in fs)
    assert files == ours
    # every metric of the dispatch was written somewhere
    assert {os.path.basename(f).rsplit("_", 1)[0] for f in files} == {
        "mae", "mse", "nll", "coverage", "acc", "auc", "f1", "median_interval_width",
        "average_interval_width"}
    for f in files:
        _same_table(tmp_path / "torch" / f, tmp_path / "jax" / f)

    names = [c[0] for c in cells]
    for module, root in ((jmetrics, "jax"), (metrics, "torch")):
        results = str(tmp_path / root)
        # gamma has no results: reported and left out
        module.concatenate_metrics(results, ["train", "test"], names[:3], ["alpha", "gamma"],
                                   ["mse", "coverage"])
        module.concatenate_metrics(results, ["train", "test"], names[3:], ["beta"], ["nll", "auc"])
        module.concatenate_metrics(results, ["test"], names[2:3], ["alpha"], ["average_interval_width"])
    for table in ("mse_train.csv", "mse_test.csv", "nll_train.csv", "nll_test.csv",
                  "average_interval_width_test.csv"):
        _same_table(tmp_path / "torch" / table, tmp_path / "jax" / table)
    # coverage and auc exist for one model of the joined ones: the dataset
    # misses a model's file, so those tables are not written
    for table in ("coverage_train.csv", "coverage_test.csv", "auc_train.csv", "auc_test.csv"):
        assert not (tmp_path / "jax" / table).exists()
        assert not (tmp_path / "torch" / table).exists()


def test_nan_cells_are_written_empty(tmp_path):
    os.makedirs(tmp_path / "m")
    metrics._write(math.nan, str(tmp_path), "m", "d", "nll_test.csv")
    metrics._write(0.1 + 0.2, str(tmp_path), "m", "e", "mse_test.csv")
    assert (tmp_path / "m" / "nll_test.csv").read_text() == "dataset,m\nd,\n"
    assert (tmp_path / "m" / "mse_test.csv").read_text() == "dataset,m\ne,0.30000000000000004\n"
