"""The port's curves, their data draws, the mixture initialisation, the 1-D
prediction runner, the mixture summary and the Poisson study's long CSV,
held to the JAX harness's (``experiments/curves``) on the CPU in fp64.

Tolerances: the curves at rtol 1e-12 on the same grid (the same formulas;
the sines differ by ulps); the mixture initialisation at 1e-12 with JAX's
normals injected; the summary's estimated shift at 1e-10 on one prediction
cloud given to both (the same arithmetic in another library). The data
draws come from torch generators, not ``jax.random``: their laws are held
to the model within 4 standard errors of each moment, and their splits to
JAX's (the same points, up to the ulps of linspace).
"""

import contextlib
import io
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from experiments.curves import curves as jcurves
from experiments.curves.classification import main as jclassification
from experiments.curves.mixture_likelihood import main as jmixture
from experiments.curves.mixture_likelihood import summarise as jsummarise
from experiments.curves.poisson_regression import main as jpoisson
from experiments.curves.poisson_regression import study as jstudy
from experiments.curves.regression import main as jregression
from experiments_torch.curves import curves as tcurves
from experiments_torch.curves.classification import main as tclassification
from experiments_torch.curves.mixture_likelihood import main as tmixture
from experiments_torch.curves.mixture_likelihood import summarise as tsummarise
from experiments_torch.curves.poisson_regression import main as tpoisson
from experiments_torch.curves.poisson_regression import study as tstudy
from experiments_torch.curves.regression import main as tregression
from experiments_torch.data import Data, ExperimentData, ProblemType
from experiments_torch.runners import predict_pls_1d_particles_runner
from projected_langevin_sampling_torch.models.conformalise import ConformalisePLS
from projected_langevin_sampling_torch.models.pls import PLS
from tests.torch_parity import onb_model, to_np

GRID = np.linspace(-3, 3, 1000).reshape(-1, 1)
LARGE = 20_000  # points of the law checks: 4 standard errors of a mean are 3% of its std


@pytest.mark.parametrize("index", range(10))
def test_curve_matches_jax(index):
    jcurve, tcurve = jcurves.CURVE_FUNCTIONS[index], tcurves.CURVE_FUNCTIONS[index]
    assert (type(tcurve).__name__, tcurve.seed, tcurve.__name__) == (
        type(jcurve).__name__, jcurve.seed, jcurve.__name__)
    np.testing.assert_allclose(to_np(tcurve.calculate_curve(torch.from_numpy(GRID))),
                               np.asarray(jcurve.calculate_curve(jnp.asarray(GRID))), rtol=1e-12)


def test_regression_draw_law():
    curve = tcurves.CURVE_FUNCTIONS[1]
    x = torch.linspace(-3, 3, LARGE, dtype=torch.float64).reshape(-1, 1)
    y = curve.regression(x, sigma_true=0.2)
    assert y.shape == (LARGE,) and y.dtype == torch.float64
    noise = (y - curve.calculate_curve(x).reshape(-1)) / 0.2
    assert abs(float(noise.mean())) < 4 / math.sqrt(LARGE)
    # the variance of a sample variance of normals is 2 / N
    assert abs(float(noise.var()) - 1) < 4 * math.sqrt(2 / LARGE)
    # the default draw is the curve's seed; the same seed draws the same noise
    torch.testing.assert_close(y, curve.regression(x, 0.2, generator=curve.seed), rtol=0, atol=0)
    assert not torch.equal(y, curve.regression(x, 0.2, generator=0))


def test_classification_draw_law():
    x = torch.linspace(-3, 3, LARGE, dtype=torch.float64).reshape(-1, 1)
    y_curve = 2 * tcurves.CURVE_FUNCTIONS[1].calculate_curve(x).reshape(-1)
    labels = tcurves.Curve.classification(y_curve, generator=0)
    assert labels.shape == (LARGE,) and labels.dtype == torch.float64
    assert set(labels.unique().tolist()) <= {0.0, 1.0}
    p = torch.sigmoid(y_curve)
    spread = math.sqrt(float(torch.sum(p * (1 - p)))) / LARGE
    assert abs(float(labels.mean() - p.mean())) < 4 * spread
    # labels follow the probability: the mean of y - p over the half where
    # p > 0.5 is 0 as well
    high = p > 0.5
    assert abs(float((labels - p)[high].mean())) < 4 * math.sqrt(
        float(torch.sum((p * (1 - p))[high]))) / int(high.sum())


def test_poisson_draw_law():
    data = tpoisson.get_experiment_data(tcurves.CURVE_FUNCTIONS[1], LARGE, 0, 1, 12,
                                        device="cpu")
    y, rate = data.full.y, data.full.y_untransformed
    assert y.shape == rate.shape == (LARGE,) and y.dtype == torch.float64
    assert torch.equal(y, torch.round(y)) and bool((y >= 0).all())
    # E[y - rate] = 0 with variance sum(rate); E[(y - rate)^2 - rate] = 0
    # with variance sum(2 rate^2 + rate)
    assert abs(float(torch.sum(y - rate))) < 4 * math.sqrt(float(rate.sum()))
    assert abs(float(torch.sum((y - rate) ** 2 - rate))) < 4 * math.sqrt(
        float(torch.sum(2 * rate**2 + rate)))


# each main's data: the port's split is the JAX main's, the draws are the
# port's own (same shapes, dtypes and inputs)
SPLITS = {
    "regression": (jregression, tregression,
                   dict(number_of_data_points=500, seed=0, sigma_true=0.2,
                        number_of_test_intervals=1, total_number_of_intervals=12,
                        validation_data_percentage=0.1)),
    "classification": (jclassification, tclassification,
                       dict(number_of_data_points=500, seed=0, number_of_test_intervals=1,
                            total_number_of_intervals=12)),
    "poisson_regression": (jpoisson, tpoisson,
                           dict(number_of_data_points=1000, seed=0, number_of_test_intervals=1,
                                total_number_of_intervals=12)),
    "mixture_likelihood": (jmixture, tmixture,
                           dict(number_of_data_points=1000, seed=0, bernoulli_probability_true=0.5,
                                bernoulli_shift_true=20.0, sigma_true=1.0,
                                train_data_percentage=0.6, validation_data_percentage=0.0)),
}


@pytest.mark.parametrize("main", list(SPLITS))
def test_data_splits_match_jax(main):
    jmain, tmain, kwargs = SPLITS[main]
    jdata = jmain.get_experiment_data(curve_function=jcurves.CURVE_FUNCTIONS[1], **kwargs)
    tdata = tmain.get_experiment_data(curve_function=tcurves.CURVE_FUNCTIONS[1], device="cpu",
                                      **kwargs)
    assert tdata.name == jdata.name and tdata.problem_type.value == jdata.problem_type.value
    for part in ("full", "train", "test", "validation"):
        jpart, tpart = getattr(jdata, part), getattr(tdata, part)
        assert (jpart is None) == (tpart is None), part
        if jpart is None:
            continue
        # the same points, up to the ulps by which the libraries' linspace differ
        np.testing.assert_allclose(to_np(tpart.x), np.asarray(jpart.x), rtol=0, atol=4e-15)
        assert tpart.y.shape == np.asarray(jpart.y).shape and tpart.y.dtype == torch.float64
        assert (tpart.y_untransformed is None) == (jpart.y_untransformed is None), part
        if jpart.y_untransformed is not None and main != "mixture_likelihood":
            # the true rate or probability is no draw
            np.testing.assert_allclose(to_np(tpart.y_untransformed),
                                       np.asarray(jpart.y_untransformed), rtol=1e-12)


def test_mixture_shift_is_one_bernoulli_draw():
    data = tmixture.get_experiment_data(tcurves.CURVE_FUNCTIONS[1], **SPLITS[
        "mixture_likelihood"][2], device="cpu")
    y_curve = 2 * tcurves.CURVE_FUNCTIONS[1].calculate_curve(data.full.x).reshape(-1)
    shift = data.full.y_untransformed - y_curve
    assert float(shift.max() - shift.min()) < 1e-12 and float(shift[0]) in (0.0, 20.0)
    noise = data.full.y - y_curve  # sigma_true 1
    assert abs(float(noise.mean())) < 4 / math.sqrt(1000)


def test_generate_init_particles_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 12))
    eigenvalues, eigenvectors = np.linalg.eigh(a @ a.T / 12 + 0.1 * np.eye(12))
    kwargs = dict(initial_particle_noise=1e-4, approximation_dimension=12, number_of_particles=50,
                  initial_particles_lower=-1.0, initial_particles_shift_scale=0.15,
                  bernoulli_shift_true=20.0, basis_dimension=16)
    expected = jmixture.generate_init_particles(
        basis_eigenvectors=jnp.asarray(eigenvectors), basis_eigenvalues=jnp.asarray(eigenvalues),
        key=0, **kwargs)
    normals = jax.random.normal(jax.random.key(0), (12, 50), dtype=jnp.float64)
    got = tmixture.generate_init_particles(
        basis_eigenvectors=torch.from_numpy(eigenvectors),
        basis_eigenvalues=torch.from_numpy(eigenvalues),
        normals=torch.from_numpy(np.asarray(normals)), **kwargs)
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=1e-12, atol=1e-14)
    # without injected normals: the host generator's, reproducibly
    drawn = tmixture.generate_init_particles(basis_eigenvectors=torch.from_numpy(eigenvectors),
                                             basis_eigenvalues=torch.from_numpy(eigenvalues),
                                             generator=0, **kwargs)
    assert torch.equal(drawn, tmixture.generate_init_particles(
        basis_eigenvectors=torch.from_numpy(eigenvectors),
        basis_eigenvalues=torch.from_numpy(eigenvalues), generator=0, **kwargs))


def _experiment_data(tbasis, y_untransformed):
    x = tbasis.kernel.approximation_samples
    y = torch.sin(2 * x[:, 0])
    full = Data(x=x, y=y, y_untransformed=torch.exp(y) if y_untransformed else None, name="full")
    return ExperimentData(name="c", problem_type=ProblemType.REGRESSION, full=full, train=full,
                          test=full, validation=full)


@pytest.mark.parametrize("y_untransformed", [False, True])
def test_predict_runner_makes_the_plotted_predictions(y_untransformed):
    _, _, tbasis, tcost, u0 = onb_model("gaussian")
    pls, particles = PLS(basis=tbasis, cost=tcost), torch.from_numpy(u0)
    data = _experiment_data(tbasis, y_untransformed)
    x = data.full.x
    distribution, samples, untransformed = predict_pls_1d_particles_runner(
        pls=pls, particles=particles, experiment_data=data)
    torch.testing.assert_close(distribution.mean,
                               pls.predict(x=x, particles=particles, generator=0).mean)
    torch.testing.assert_close(samples, pls.predict_samples(x=x, particles=particles,
                                                            generator=1))
    if y_untransformed:
        torch.testing.assert_close(untransformed, pls.predict_untransformed_samples(
            x=x, particles=particles, generator=2))
    else:
        assert untransformed is None
    conformal = ConformalisePLS(x_calibration=x, y_calibration=data.full.y, pls=pls,
                                particles=particles)
    distribution, samples, untransformed = predict_pls_1d_particles_runner(
        pls=conformal, particles=particles, experiment_data=data)
    assert samples is None and untransformed is None and distribution.mean.shape == (x.shape[0],)
    with pytest.raises(TypeError):
        predict_pls_1d_particles_runner(pls=object(), particles=particles, experiment_data=data)


@pytest.mark.parametrize("main", [tregression, tclassification, tpoisson, tmixture])
def test_include_gif_names_the_missing_plotting_library(main):
    with pytest.raises(NotImplementedError, match="matplotlib"):
        main.main(curve_function=tcurves.CURVE_FUNCTIONS[0], data_config={}, kernel_config={},
                  inducing_points_config={}, pls_config={}, outputs_path="unused",
                  include_gif=True, device="cpu", **(
                      {} if main is tmixture else {"svgp_config": {}}))


# --- the mixture summary -------------------------------------------------------
CLOUD_CURVES = {"curve1": "bimodal", "curve2": "bimodal", "curve4": "one mode",
                "curve7": "no candidate"}


def _cloud(kind: str, n=40, j=50, seed=0):
    """(N, J) untransformed predictions: particles around the curve's level
    (about 0.3) and 20 above it, or all in the curve's mode."""
    rng = np.random.default_rng(seed)
    level = 0.3 + 20.0 * (rng.uniform(size=j) < (0.6 if kind == "bimodal" else 0.0))
    return level[None, :] + rng.normal(scale=0.5, size=(n, j))


class _Stub:
    """Whatever the summary builds on the way to its PLS model."""

    def __init__(self, *args, **kwargs):
        pass


def _summary_run(module, outputs, mp, to_array):
    """``module.main`` with every curve's data, kernel, basis and checkpoint
    stubbed: the checkpoints of CLOUD_CURVES exist, and each PLS predicts
    its curve's cloud."""
    y_train = np.full(40, 0.3)
    current = {}

    def data(curve_function, **kwargs):
        current["curve"] = type(curve_function).__name__.lower()
        return ExperimentData(name="c", problem_type=ProblemType.MULTIMODAL_REGRESSION,
                              full=None, train=Data(x=to_array(np.zeros((40, 1))),
                                                    y=to_array(y_train)))

    class Model(_Stub):
        def predict_untransformed_samples(self, particles, x, **kw):
            return to_array(_cloud(CLOUD_CURVES[current["curve"]],
                                   seed=int(current["curve"][5:])))

    def load(path, pls):
        no_candidate = CLOUD_CURVES[current["curve"]] == "no candidate"
        return None, None, None if no_candidate else 1e-3, 10

    mp.setattr(module, "get_experiment_data", data)
    mp.setattr(module, "learn_kernel_and_inducing_points",
               lambda **kw: (None, None, None, None, Data(x=None), None))
    mp.setattr(module, "build_orthonormal_basis", lambda **kw: None)
    mp.setattr(module, "MultiModalCost", _Stub)
    mp.setattr(module, "PLS", Model)
    mp.setattr(module, "load_pls", load)
    for curve in CLOUD_CURVES:
        os.makedirs(os.path.join(outputs, "models", curve), exist_ok=True)
        open(os.path.join(outputs, "models", curve, "pls-onb.pkl"), "w").close()


def test_mixture_summary_matches_jax(tmp_path):
    from experiments_torch.config import load_config

    config = "experiments/curves/mixture_likelihood/config.yaml"
    # the JAX summary reads its config and outputs beside the script and
    # writes the table under results/ three directories above it
    jroot = tmp_path / "a" / "b" / "c"
    jroot.mkdir(parents=True)
    (jroot / "config.yaml").write_text(open(config).read())
    rows = {}
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        _summary_run(jsummarise, str(jroot / "outputs"), mp, jnp.asarray)
        mp.setattr(jsummarise, "ROOT", str(jroot))
        rows["jax"] = [jsummarise.summarise_curve(c, jsummarise.yaml.safe_load(open(config)),
                                                  "outputs")
                       for c in jcurves.CURVE_FUNCTIONS]
        mp.setattr(sys, "argv", ["summarise.py"])
        jsummarise.main()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        _summary_run(tsummarise, str(tmp_path / "torch"), mp, torch.from_numpy)
        rows["torch"] = [tsummarise.summarise_curve(c, load_config(config), str(tmp_path / "torch"),
                                                    device="cpu")
                         for c in tcurves.CURVE_FUNCTIONS]
        written = tsummarise.main(["--outputs_dirname", str(tmp_path / "torch"),
                                   "--config_path", config, "--device", "cpu"])
    assert [r["curve"] for r in written] == [r["curve"] for r in rows["torch"] if r is not None]
    kinds = [r and CLOUD_CURVES[r["curve"]] for r in rows["torch"]]
    assert kinds.count(None) == 6 and kinds.count("bimodal") == 2
    for jrow, trow in zip(rows["jax"], rows["torch"], strict=True):
        assert (jrow is None) == (trow is None)
        if jrow is None:
            continue
        assert {k: v for k, v in trow.items() if k != "est_shift"} == {
            k: v for k, v in jrow.items() if k != "est_shift"}
        if math.isnan(jrow["est_shift"]):
            assert math.isnan(trow["est_shift"])
        else:
            np.testing.assert_allclose(trow["est_shift"], jrow["est_shift"], rtol=1e-10)
    assert (tmp_path / "torch" / "mixture_summary.md").read_text() == (
        tmp_path / "results" / "mixture_summary.md").read_text()


# --- the Poisson study's long CSV ------------------------------------------------
def _study_rows(seed):
    rng = np.random.default_rng(seed)
    return [dict(curve=f"curve{c}", seed=s, model=m, metric=metric, split=split,
                 value=float("nan") if rng.uniform() < 0.05 else float(rng.normal() * 10 ** c))
            for c in (1, 2, 10) for s in (0, 3) for m in ("pls-onb", "svgp-gaussian")
            for metric in ("nll", "rate_rmse") for split in ("test", "train")
            if rng.uniform() < 0.7]


def test_study_long_csv_merges_as_the_jax_study(tmp_path, monkeypatch):
    jcsv, tcsv = str(tmp_path / "jax" / "long.csv"), str(tmp_path / "torch" / "long.csv")
    monkeypatch.setattr(jstudy, "LONG_CSV", jcsv)
    for seed in (0, 1, 2):  # a new file, then merges that replace and add rows
        jstudy._merge_rows(_study_rows(seed))
        tstudy.merge_rows(_study_rows(seed), tcsv)
        jlines, tlines = open(jcsv).read().splitlines(), open(tcsv).read().splitlines()
        assert len(tlines) == len(jlines) and tlines[0] == jlines[0]
        for jline, tline in zip(jlines[1:], tlines[1:]):
            assert tline.rsplit(",", 1)[0] == jline.rsplit(",", 1)[0]
            jv, tv = jline.rsplit(",", 1)[1], tline.rsplit(",", 1)[1]
            assert (jv == "") == (tv == "")
            if seed == 0:  # a new file: the same text
                assert tv == jv
            elif jv:
                # pandas' parser reads a cell back up to an ulp off, and the
                # JAX study writes that; the port's reads are exact
                np.testing.assert_allclose(float(tv), float(jv), rtol=4e-16)
    done = pd.read_csv(jcsv)
    rows = tstudy.read_long_csv(tcsv)
    assert len(rows) == len(done) and [r["seed"] for r in rows] == done.seed.tolist()
    for curve, seed in (("curve1", 0), ("curve2", 3), ("curve10", 5)):
        committed = {m for m in ("pls-onb", "svgp-gaussian") if (
            (done.curve == curve) & (done.seed == seed) & (done.model == m)
            & (done.metric == "nll") & (done.split == "test")).any()}
        assert tstudy.missing_models(rows, curve, seed, ("pls-onb", "svgp-gaussian")) == [
            m for m in ("pls-onb", "svgp-gaussian") if m not in committed]


# --- one cell of the Poisson study --------------------------------------------------
def _study_config(config):
    config["data"]["number_of_data_points"] = 120
    config["kernel"]["number_of_epochs"] = 10
    config["pls"].update(number_of_step_searches=2, maximum_number_of_steps=300)
    config["svgp"].update(number_of_epochs=5, number_of_learning_rate_searches=2)
    return config


@pytest.fixture(scope="module")
def study_cell(tmp_path_factory):
    """One cell (curve 2, data seed 0) of both studies, the port's on the
    JAX study's data; returns (root, records by package)."""
    import yaml

    from experiments import plotters as jplotters
    from experiments_torch.config import load_config
    from tests.test_torch_curves_mains import one_thread, to_port

    root = tmp_path_factory.mktemp("study")
    path = "experiments/curves/poisson_regression/config.yaml"
    records = {"jax": {}, "torch": {}}
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()), \
            one_thread():
        for attr in dir(jplotters):
            if attr.startswith("plot_"):
                mp.setattr(jplotters, attr, lambda *a, **k: None)
        for package, module in (("jax", jstudy), ("torch", tstudy)):
            for name in ("train_svgp_runner", "fit_mean_constant_map", "get_experiment_data"):
                def wrapper(*args, _fn=getattr(module, name), _name=name, _record=records[package],
                            **kwargs):
                    out = _fn(*args, **kwargs)
                    _record.setdefault(_name, []).append(out)
                    return out

                mp.setattr(module, name, wrapper)
        mp.setattr(jstudy, "LONG_CSV", str(root / "jax" / "long.csv"))
        jstudy.run_cell(jcurves.CURVE_FUNCTIONS[1], 0, _study_config(yaml.safe_load(open(path))),
                        str(root / "jax"))
        mp.setattr(tstudy, "get_experiment_data",
                   lambda **kw: to_port(records["jax"]["get_experiment_data"][0]))
        tstudy.run_cell(tcurves.CURVE_FUNCTIONS[1], 0, _study_config(load_config(path)),
                        str(root / "torch"), str(root / "torch" / "long.csv"), device="cpu")
    return root, records


def test_study_cell_matches_jax(study_cell):
    root, records = study_cell
    jrows = pd.read_csv(root / "jax" / "long.csv")
    trows = tstudy.read_long_csv(str(root / "torch" / "long.csv"))
    # the same layout and rows: 4 models, nll/mse/mae on both splits, and the
    # rate RMSE of each model on both splits
    assert open(root / "torch" / "long.csv").readline() == open(root / "jax" / "long.csv").readline()
    assert [tuple(r[k] for k in tstudy.KEYS) for r in trows] == list(
        jrows[tstudy.KEYS].itertuples(index=False, name=None))
    assert len(trows) == 4 * 4 * 2
    # the MAP mean constant and the SVGP derive from the GPs: rtol 1e-8
    np.testing.assert_allclose(records["torch"]["fit_mean_constant_map"],
                               records["jax"]["fit_mean_constant_map"], rtol=1e-8)
    (jsvgp, jlosses, _), = records["jax"]["train_svgp_runner"]
    (tsvgp, tlosses, _), = records["torch"]["train_svgp_runner"]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-8)
    for key in ("variational_mean", "variational_chol"):
        np.testing.assert_allclose(to_np(getattr(tsvgp, key)), to_np(getattr(jsvgp, key)),
                                   rtol=1e-8, atol=1e-12)
    for trow, (_, jrow) in zip(trows, jrows.iterrows()):
        assert math.isfinite(trow["value"]), trow
        if trow["model"] == "svgp-gaussian":
            np.testing.assert_allclose(trow["value"], jrow["value"], rtol=1e-8)
        else:
            # the PLS rows carry each package's own noise: within the loosest
            # band of the Poisson main's test (tests/test_torch_curves_mains.py)
            assert 1 / 2.5 <= trow["value"] / jrow["value"] <= 2.5, trow
