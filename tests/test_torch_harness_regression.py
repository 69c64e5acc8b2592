"""The UCI regression main of both harnesses end to end, on the CPU in fp64:
the same 300-row synthetic kin8nm (the JAX generator's) and the headline
config (``config_precond_map.yaml``) cut in depth: 2 subsample GPs of 100
rows and 30 epochs, 2 step-size candidates of at most 2000 steps, 2 SVGP
learning rates of 10 epochs.

- Every results file and checkpoint the JAX main writes (plots aside)
  exists in the port's tree with the same name; every CSV has the same
  header and index.
- What derives from the GPs matches at rtol 1e-8: the averaged kernel,
  noise and mean constant, the inducing points, the Student-T degrees of
  freedom and scale, and every ``svgp*`` value.
- The ``pls*`` values come from other (seeded) noise in each package and
  are held within a band (see ``test_pls_values_within_the_band``).
- Run again on the JAX main's draws (``tests/torch_parity.Carrier``: its
  initial particles, every step's normals, its predictive and observation
  noise), from the port's own GP and SVGP checkpoints, the port's main
  gives every ``pls*`` value, chosen step size, steps run and trained
  particles of the JAX main's (``test_pls_values_match_jax_on_carried_draws``).
"""

import contextlib
import io
import math
import os
import shutil

import numpy as np
import pytest
import yaml

from experiments import metrics as jmetrics
from experiments import plotters as jplotters
from experiments.uci import make_synthetic_datasets as jsynthetic
from experiments.uci.regression import main as jmain
from experiments_torch.config import load_config
from experiments_torch.metrics import concatenate_seed
from experiments_torch.uci.regression import main as tmain
from tests.torch_parity import Carrier, drop_pls_checkpoints, one_thread, to_np

CONFIG = "experiments/uci/regression/config_precond_map.yaml"
CUTS = {"kernel": dict(number_of_iterations=2, number_of_epochs=30, subsample_size=100),
        "pls": dict(number_of_step_searches=2, maximum_number_of_steps=2000),
        "svgp": dict(number_of_learning_rate_searches=2, number_of_epochs=10)}
RECORDED = ("construct_average_ard_kernel", "construct_average_gaussian_likelihood_from_models",
            "construct_average_mean_constant", "estimate_student_parameters",
            "inducing_points_runner")


def _cut(config):
    for section, values in CUTS.items():
        config[section].update(values)
    return config


def _recording(module, record, mp):
    for name in RECORDED:
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            record[_name] = out
            return out

        mp.setattr(module, name, wrapper)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("uci_regression")
    datasets = root / "experiments" / "uci" / "datasets"
    with contextlib.redirect_stdout(io.StringIO()):
        jsynthetic.main(300, str(datasets))
    with open(CONFIG) as f:
        jconfig = _cut(yaml.safe_load(f))
    tconfig = _cut(load_config(CONFIG))
    records = {"jax": {}, "torch": {}}
    carrier = Carrier()
    out = io.StringIO()
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out), one_thread():
        # the JAX main's plots are no part of the comparison
        for name in ("plot_true_versus_predicted", "plot_losses", "plot_energy_potentials"):
            mp.setattr(jplotters, name, lambda *a, **k: None)
        mp.setattr(jmain, "plot_eigenvalues", lambda *a, **k: None)
        _recording(jmain, records["jax"], mp)
        _recording(tmain, records["torch"], mp)
        carrier.record_jax(mp, [jmain])
        sections = {k: f"{k}_config" for k in ("kernel", "pls", "svgp", "metrics")}
        sections.update(data="data_config", inducing_points="inducing_points_config")
        try:
            os.chdir(root)  # the JAX main reads experiments/uci/datasets from here
            jmain.main(data_seed=0, dataset_name="kin8nm", outputs_path=str(root / "jax"),
                       **{arg: jconfig[k] for k, arg in sections.items()})
        finally:
            os.chdir(cwd)
        tmain.main(data_seed=0, dataset_name="kin8nm", outputs_path=str(root / "torch"),
                   datasets_dir=str(datasets), device="cpu",
                   **{arg: tconfig[k] for k, arg in sections.items()})
        jmetrics.concatenate_metrics(str(root / "jax" / "0" / "results"), ["train", "test"],
                                     jmain.MODEL_NAMES, ["kin8nm"], jmain.METRICS)
        concatenate_seed(str(root / "torch"), 0, ["kin8nm"], tmain.MODEL_NAMES, tmain.METRICS)
        # the port's main again on the JAX main's draws, from its own GP and
        # SVGP checkpoints: only the PLS models train
        shutil.copytree(root / "torch", root / "carried")
        drop_pls_checkpoints(root / "carried")
        carrier.carry_port(mp, [tmain])
        tmain.main(data_seed=0, dataset_name="kin8nm", outputs_path=str(root / "carried"),
                   datasets_dir=str(datasets), device="cpu",
                   **{arg: tconfig[k] for k, arg in sections.items()})
        carrier.drained()
    return root, records, out.getvalue(), carrier


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top) for d, _, fs in os.walk(top)
                  for f in fs if "plots" not in os.path.relpath(d, top).split(os.sep))


def _value(path):
    with open(path) as f:
        header, row = f.read().splitlines()[:2]
    return header, row.split(",")[0], (math.nan if row.split(",")[1] == "" else
                                       float(row.split(",")[1]))


def test_the_port_writes_every_file_of_the_jax_main(runs):
    root, _, log, _ = runs
    jax_files, port_files = _files(root / "jax"), _files(root / "torch")
    assert jax_files == port_files
    csvs = [f for f in jax_files if f.endswith(".csv")]
    assert len(csvs) > 100 and any(f.startswith(os.path.join("0", "results", "mse_")) for f in csvs)
    for f in csvs:
        with open(root / "jax" / f) as a, open(root / "torch" / f) as b:
            ja, tb = a.read().splitlines(), b.read().splitlines()
        assert len(ja) == len(tb) and ja[0] == tb[0]
        assert [r.split(",")[0] for r in ja] == [r.split(",")[0] for r in tb]
    # the candidates ran on the tiers the config resolves to
    assert "tier=spectral" in log and "tier=off" in log and "[stage]" in log


def test_gp_derived_quantities_match_jax(runs):
    _, records, _, _ = runs
    j, t = records["jax"], records["torch"]
    for name in ("lengthscales", "outputscale"):
        np.testing.assert_allclose(to_np(getattr(t["construct_average_ard_kernel"], name)),
                                   to_np(getattr(j["construct_average_ard_kernel"], name)),
                                   rtol=1e-8)
    np.testing.assert_allclose(
        to_np(t["construct_average_gaussian_likelihood_from_models"].noise),
        to_np(j["construct_average_gaussian_likelihood_from_models"].noise), rtol=1e-8)
    np.testing.assert_allclose(to_np(t["construct_average_mean_constant"]),
                               to_np(j["construct_average_mean_constant"]), rtol=1e-8)
    # the same rows: pandas' float parser, which the JAX main reads the CSV
    # with, may land an ulp from the value the text names (the port's reads
    # round-trip)
    np.testing.assert_allclose(to_np(t["inducing_points_runner"].x),
                               to_np(j["inducing_points_runner"].x), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(t["estimate_student_parameters"],
                               j["estimate_student_parameters"], rtol=1e-8)


def test_svgp_values_match_jax(runs):
    root, _, _, _ = runs
    results = os.path.join("0", "results")
    files = [f for f in _files(root / "jax" / results) if f.startswith(os.path.join("kin8nm", "svgp"))]
    # svgp and svgp-student: plain and tempered 6 files each, conformalised 12
    assert len(files) == 2 * (6 + 6 + 12)
    for f in files:
        jh, ji, jv = _value(root / "jax" / results / f)
        th, ti, tv = _value(root / "torch" / results / f)
        assert (th, ti) == (jh, ji)
        np.testing.assert_allclose(tv, jv, rtol=1e-8)


# The pls* values. At 300 rows (30 test points) the predictive draw alone
# moves them: on this CPU, ten draws of the port's predict on one trained
# pls-onb gave a test MSE of 0.517-0.654, and eight training seeds at one
# draw 0.532-0.540; the JAX harness's six seeds gave 0.502-0.517 at its own
# draw. Each package draws its own noise, so the means, errors and NLLs of
# the plain and tempered models are held within 40% relative, the coverage
# within 0.15 (4.5 of the 30 test points), and every port value but the
# conformal NLL must be finite. The conformal NLL scores a Gaussian whose
# std is half the 2/3 interval, and with the Student-T extra noise the
# negative conformal correction can close an interval to zero width; the
# JAX harness then writes NaN too (5 of its 6 seeds for
# pls-student-onb-conformalise's train NLL), so it is only compared where
# both are finite, within a factor of 4 (the port's eight seeds spread
# 1.2-2.5 on the train split and 1.9-7.2 on the test split). The
# conformalised models' errors and interval widths rest on 30 calibration
# points as well: within a factor of 2 (the seed-0 pair differed by up to
# 1.51, the average interval width on the test split).
BAND = {"mae": 0.4, "mse": 0.4, "nll": 0.4}


def test_pls_values_within_the_band(runs):
    root, _, _, _ = runs
    results = os.path.join("0", "results")
    files = [f for f in _files(root / "jax" / results)
             if f.startswith(os.path.join("kin8nm", "pls"))]
    assert len(files) == 2 * (6 + 6 + 12)
    for f in files:
        model, name = f.split(os.sep)[1:]
        metric = name.rsplit("_", 1)[0]
        _, _, jv = _value(root / "jax" / results / f)
        _, _, tv = _value(root / "torch" / results / f)
        conformal_nll = model.endswith("conformalise") and metric == "nll"
        assert math.isfinite(tv) or conformal_nll, f
        if metric == "coverage":
            assert abs(tv - jv) <= 0.15, f
        elif conformal_nll:
            if math.isfinite(jv) and math.isfinite(tv):
                assert 0.25 <= tv / jv <= 4.0, f
        elif metric in BAND and not model.endswith("conformalise"):
            assert abs(tv - jv) <= BAND[metric] * abs(jv), f
        else:  # the conformal models' errors and interval widths
            assert 0.5 <= tv / jv <= 2.0, f


def test_pls_values_match_jax_on_carried_draws(runs):
    """On the JAX main's draws the port's main gives the JAX main's PLS
    results: every train_pls call's energies and particles, each model's
    chosen step size and steps run, and every ``pls*`` results value at
    rtol 1e-7. The conformal NLL is NaN where the JAX main's is (a
    zero-width interval)."""
    root, records, _, carrier = runs
    results = os.path.join("0", "results")
    assert len(carrier.jax["train"]) >= 4
    assert {r["tier"] for r in carrier.jax["train"]} == {"spectral", "off"}
    carrier.assert_runs_match(rtol=1e-7)
    files = [f for f in _files(root / "jax" / results)
             if f.startswith(os.path.join("kin8nm", "pls"))]
    assert len(files) == 2 * (6 + 6 + 12)
    for f in files:
        jh, ji, jv = _value(root / "jax" / results / f)
        th, ti, tv = _value(root / "carried" / results / f)
        assert (th, ti) == (jh, ji)
        if math.isnan(jv):
            assert math.isnan(tv), f
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-7, err_msg=f)
