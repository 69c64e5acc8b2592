"""The four curve mains of both harnesses end to end, on the CPU in fp64:
curve 2, each main's own config cut in depth and to 120 data points (one
exact GP of 10 epochs, two SVGP learning rates of 5 epochs, step-size
candidates of at most 300 steps), the JAX main's data (and, for the
mixture, its initial normals) carried into the port's main.

- Every checkpoint and results file the JAX main writes (plots aside)
  exists in the port's tree with the same name; every CSV has the same
  header and index.
- What derives from the GPs matches at rtol 1e-8: the averaged kernel,
  noise and mean constant, the inducing points, the ONB eigenvalues, and
  the SVGP (its variational parameters and its test predictive).
- The PLS values come from other (seeded) noise in each package and are
  held within bands (see ``test_pls_values_within_the_band``).
- The port's PLS models on the JAX main's particles and noise predict what
  JAX's predict, metrics included, at rtol 1e-7.
- Run again on the JAX main's draws (``tests/torch_parity.Carrier``), from
  its own GP and SVGP checkpoints, the port's main gives every ``pls*``
  value, chosen step size, steps run and trained particles of the JAX
  main's at rtol 1e-7; so do the two preconditioned configs
  (``config_precond.yaml`` of the regression and mixture mains), run on
  the JAX main's data and draws alone.
"""

import contextlib
import io
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from experiments import plotters as jplotters
from experiments.curves import common as jcommon
from experiments.curves.classification import main as jclassification
from experiments.curves.mixture_likelihood import main as jmixture
from experiments.curves.poisson_regression import main as jpoisson
from experiments.curves.regression import main as jregression
from experiments.curves.curves import CURVE_FUNCTIONS as JCURVES
from experiments_torch.config import load_config
from experiments_torch.curves import common as tcommon
from experiments_torch.curves.classification import main as tclassification
from experiments_torch.curves.curves import CURVE_FUNCTIONS as TCURVES
from experiments_torch.curves.mixture_likelihood import main as tmixture
from experiments_torch.curves.poisson_regression import main as tpoisson
from experiments_torch.curves.regression import main as tregression
from experiments_torch.data import Data, ExperimentData, ProblemType
from tests.torch_parity import Carrier, drop_pls_checkpoints, one_thread, to_np

CURVE = 2
MAINS = {
    "regression": (jregression, tregression, "experiments/curves/regression/config.yaml"),
    "classification": (jclassification, tclassification,
                       "experiments/curves/classification/config.yaml"),
    "poisson_regression": (jpoisson, tpoisson, "experiments/curves/poisson_regression/config.yaml"),
    "mixture_likelihood": (jmixture, tmixture, "experiments/curves/mixture_likelihood/config.yaml"),
}
PRECOND = {"regression": "experiments/curves/regression/config_precond.yaml",
           "mixture_likelihood": "experiments/curves/mixture_likelihood/config_precond.yaml"}
RECORDED = ("construct_average_ard_kernel", "construct_average_gaussian_likelihood_from_models",
            "construct_average_mean_constant", "inducing_points_runner",
            "build_orthonormal_basis", "train_svgp_runner")


def cut(config, pls_seed=0):
    config["data"]["number_of_data_points"] = 120
    config["pls"].update(number_of_step_searches=2, seed=pls_seed)
    config["kernel"]["number_of_epochs"] = 10
    config["pls"]["maximum_number_of_steps"] = min(300, config["pls"]["maximum_number_of_steps"])
    if "svgp" in config:
        config["svgp"].update(number_of_epochs=5, number_of_learning_rate_searches=2)
    return config


def to_port(data) -> ExperimentData:
    """The JAX harness's ExperimentData as the port's, fp64 on the CPU."""
    def part(d):
        if d is None:
            return None
        return Data(**{k: None if getattr(d, k) is None
                       else torch.from_numpy(np.array(getattr(d, k), dtype=np.float64))
                       for k in ("x", "y", "y_untransformed")}, name=d.name)

    return ExperimentData(name=data.name, problem_type=ProblemType(data.problem_type.value),
                          full=part(data.full), train=part(data.train), test=part(data.test),
                          validation=part(data.validation), y_mean=float(data.y_mean),
                          y_std=float(data.y_std))


def _record(module, name, record, mp):
    if not hasattr(module, name):
        return
    fn = getattr(module, name)

    def wrapper(*args, _fn=fn, **kwargs):
        out = _fn(*args, **kwargs)
        record.setdefault(name, []).append(out)
        return out

    mp.setattr(module, name, wrapper)


def run_both(name, root, pls_seed=0, config_path=None, own_draws=True):
    """The JAX main, then the port's on its data (with ``own_draws``), then
    the port's again on the JAX main's draws (``records["carried"]``: the
    carrier, which keeps each main's ``train_pls_runner`` returns, and the
    port main's return), under ``root``; returns (name, root, records, the JAX main's
    models by prediction name, the JAX data, the port main's return, the
    log)."""
    jmain, tmain, default_config = MAINS[name]
    config_path = config_path or default_config
    with open(config_path) as f:
        jconfig = cut(yaml.safe_load(f), pls_seed)
    tconfig = cut(load_config(config_path), pls_seed)
    sections = {k: f"{k}_config" for k in jconfig}
    records = {"jax": {}, "torch": {}}
    carrier = Carrier()
    jax_learned, jax_data = {}, []
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log), one_thread():
        # the JAX main's plots are no part of the comparison
        for module in (jplotters, jmain, jcommon):
            for attr in dir(module):
                if attr.startswith(("plot_", "animate_")) and attr != "plot_pls_1d_particles_runner":
                    mp.setattr(module, attr, lambda *a, **k: None)

        def jax_predictions(pls, particles, particle_name, **kw):
            jax_learned[particle_name] = (pls, particles)

        for module in (jmain, jcommon):
            if hasattr(module, "plot_pls_1d_particles_runner"):
                mp.setattr(module, "plot_pls_1d_particles_runner", jax_predictions)
        for module in (jmain, jcommon):
            for recorded in RECORDED:
                _record(module, recorded, records["jax"], mp)
        for module in (tmain, tcommon):
            for recorded in RECORDED:
                _record(module, recorded, records["torch"], mp)
        mp.setattr(jmain, "get_experiment_data",
                   lambda *a, _fn=jmain.get_experiment_data, **k: jax_data.append(_fn(*a, **k))
                   or jax_data[-1])
        mp.setattr(tmain, "get_experiment_data", lambda *a, **k: to_port(jax_data[-1]))
        carrier.record_jax(mp, [jmain, jcommon])
        if name == "mixture_likelihood":
            carrier.carry_init_normals(mp, jmain, tmain)
        if name == "mixture_likelihood":
            # the JAX main's initial normals, (M_k, J) from the key pls.seed
            def carried_init(*, approximation_dimension, number_of_particles, generator,
                             _original=tmixture.generate_init_particles, **kw):
                normals = jax.random.normal(jax.random.key(generator),
                                            (approximation_dimension, number_of_particles),
                                            dtype=jnp.float64)
                return _original(
                    approximation_dimension=approximation_dimension,
                    number_of_particles=number_of_particles,
                    normals=torch.from_numpy(np.asarray(normals)), **kw)

            mp.setattr(tmain, "generate_init_particles", carried_init)
        jmain.main(curve_function=JCURVES[CURVE - 1], outputs_path=str(root / "jax"),
                   include_gif=False, **{arg: jconfig[k] for k, arg in sections.items()})
        run_port = lambda out: tmain.main(  # noqa: E731
            curve_function=TCURVES[CURVE - 1], outputs_path=str(root / out), device="cpu",
            **{arg: tconfig[k] for k, arg in sections.items()})
        port = None
        if own_draws:
            port = run_port("torch")
            # the carried run starts from the port's own GP and SVGP
            # checkpoints: only the PLS models train
            shutil.copytree(root / "torch", root / "carried")
            drop_pls_checkpoints(root / "carried")
        carrier.carry_port(mp, [tmain, tcommon])
        for module in (tmain, tcommon):
            carrier.mute(mp, module, "predict_pls_1d_particles_runner")
        own = {k: list(v) for k, v in records["torch"].items()}
        records["carried"] = dict(carrier=carrier, port=run_port("carried"))
        records["torch"] = own  # the records of the port's run on its own draws
        carrier.drained()
    return name, root, records, jax_learned, jax_data[-1], port, log.getvalue()


@pytest.fixture(scope="module", params=list(MAINS))
def run(request, tmp_path_factory):
    return run_both(request.param, tmp_path_factory.mktemp(request.param))


@pytest.fixture(scope="module", params=list(PRECOND))
def precond_run(request, tmp_path_factory):
    return run_both(request.param, tmp_path_factory.mktemp(f"{request.param}_precond"),
                    config_path=PRECOND[request.param], own_draws=False)


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top) for d, _, fs in os.walk(top)
                  for f in fs if "plots" not in os.path.relpath(d, top).split(os.sep))


def _value(path):
    with open(path) as f:
        header, row = f.read().splitlines()[:2]
    cell = row.split(",")[1]
    return header, row.split(",")[0], math.nan if cell == "" else float(cell)


def test_the_port_writes_every_file_of_the_jax_main(run):
    name, root, _, _, _, _, log = run
    jax_files, port_files = _files(root / "jax"), _files(root / "torch")
    assert jax_files == port_files
    assert any(f.endswith(".pkl") for f in jax_files)
    csvs = [f for f in jax_files if f.endswith(".csv")]
    assert bool(csvs) == (name in ("classification", "poisson_regression"))
    for f in csvs:
        with open(root / "jax" / f) as a, open(root / "torch" / f) as b:
            ja, tb = a.read().splitlines(), b.read().splitlines()
        assert len(ja) == len(tb) == 2 and ja[0] == tb[0]
        assert ja[1].split(",")[0] == tb[1].split(",")[0]
    # each candidate's line names its tier; each stage prints its seconds
    tier = "tier=spectral" if name == "regression" else "tier=off"
    assert tier in log and "[stage]" in log


def test_gp_derived_quantities_match_jax(run):
    name, _, records, _, _, _, _ = run
    j, t = records["jax"], records["torch"]
    assert len(t["construct_average_ard_kernel"]) == len(j["construct_average_ard_kernel"]) == 1
    for attr in ("lengthscales", "outputscale"):
        np.testing.assert_allclose(to_np(getattr(t["construct_average_ard_kernel"][0], attr)),
                                   to_np(getattr(j["construct_average_ard_kernel"][0], attr)),
                                   rtol=1e-8)
    np.testing.assert_allclose(
        to_np(t["construct_average_gaussian_likelihood_from_models"][0].noise),
        to_np(j["construct_average_gaussian_likelihood_from_models"][0].noise), rtol=1e-8)
    np.testing.assert_allclose(to_np(t["construct_average_mean_constant"][0]),
                               to_np(j["construct_average_mean_constant"][0]), rtol=1e-8)
    np.testing.assert_allclose(to_np(t["inducing_points_runner"][0].x),
                               to_np(j["inducing_points_runner"][0].x), rtol=1e-15, atol=1e-15)
    for tb, jb in zip(t["build_orthonormal_basis"], j["build_orthonormal_basis"], strict=True):
        np.testing.assert_allclose(to_np(tb.eigenvalues), to_np(jb.eigenvalues), rtol=1e-8)


def test_svgp_values_match_jax(run):
    name, _, records, _, data, _, _ = run
    if name not in ("regression", "classification"):
        assert "train_svgp_runner" not in records["jax"]
        return
    (jsvgp, jlosses, jlr), = records["jax"]["train_svgp_runner"]
    (tsvgp, tlosses, tlr), = records["torch"]["train_svgp_runner"]
    assert tlr == jlr
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-8)
    for key in ("variational_mean", "variational_chol", "x_induce"):
        np.testing.assert_allclose(to_np(getattr(tsvgp, key)), to_np(getattr(jsvgp, key)),
                                   rtol=1e-8, atol=1e-12)
    x_test = np.asarray(data.test.x)
    jpred, tpred = jsvgp.predict_y(jnp.asarray(x_test)), tsvgp.predict_y(torch.from_numpy(x_test))
    if name == "regression":
        np.testing.assert_allclose(to_np(tpred.mean), to_np(jpred.mean), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(to_np(tpred.variance), to_np(jpred.variance), rtol=1e-8)
    else:
        np.testing.assert_allclose(to_np(tpred.probs), to_np(jpred.probs), rtol=1e-8)


# The PLS values. Each package draws its own noise, and at this depth (70
# train points, at most 300 steps a candidate) the models are barely
# trained: over five PLS seeds of each main (0-4, the JAX main's and the
# port's on the JAX main's data), on this CPU, the values spread as follows,
# and each band is about 1.5x the largest spread (max - min) / min of its
# family over both packages' ten runs.
# - classification: NLL 17%, MSE 24%, MAE 11% (bands 0.25, 0.35, 0.2);
#   accuracy, AUC and F1 are at chance (train accuracy 0.20-0.83; absolute
#   spreads over a file's ten runs up to 0.63, 0.74 and 0.72, so 1.5x of
#   them would hold nothing) and are held to [0, 1] here, and to JAX's
#   values on carried particles and noise by
#   ``test_port_models_on_the_jax_particles_match_jax``;
# - Poisson: NLL, MSE and MAE up to 16%, 11% and 5% (bands 0.25, 0.2, 0.1),
#   but pls-ipb's test values up to a factor 1.84 (held within 2.5x): the
#   held-out intervals extrapolate a square link from an untrained IPB;
# - regression, pls-onb's test MSE: 9% (band 0.15);
# - mixture: the particles in the shifted mode 6-8 of 50 (within 4), the
#   estimated shift 13.7-14.8 (band 0.12).
BANDS = {"classification": {"nll": 0.25, "mse": 0.35, "mae": 0.2},
         "poisson_regression": {"nll": 0.25, "mse": 0.2, "mae": 0.1}}


def test_port_models_on_the_jax_particles_match_jax(run):
    """Each PLS model of the port's main, given the JAX main's trained
    particles and its predictive and observation noise (JAX keys 0 and 1),
    predicts what the JAX model predicts on the train and test splits: the
    samples at rtol 1e-7 with an atol of 1e-7 of the largest (the Poisson's
    square link loses relative precision near 0), the prediction at rtol
    1e-7 (a Bernoulli's probabilities, a Poisson's rate, a Gaussian's mean
    and variance) and, where the
    main writes metrics, accuracy, AUC and F1 to 1e-12 and NLL, MSE and MAE
    at rtol 1e-7 through each package's metric functions. The bases differ
    only by the GP fits' 1e-8, so this holds each link, threshold and
    prediction to JAX's, where the bands below cannot: the two packages'
    own runs sit near chance at this depth."""
    from experiments import metrics as jmetrics
    from experiments_torch import metrics as tmetrics

    name, _, _, jax_learned, data, port, _ = run
    carried = lambda a: torch.from_numpy(np.array(a, dtype=np.float64))  # noqa: E731
    models = (port["pls"] if isinstance(port["pls"], dict)
              else {"pls-onb": (port["pls"], port["particles"])})
    for model_name, (tpls, _) in models.items():
        jpls, jparticles = jax_learned[f"{model_name}-learned"]
        for split in (data.train, data.test):
            x, y = jnp.asarray(split.x), np.asarray(split.y)
            noise = jpls.basis.sample_predictive_noise(particles=jparticles, x=x, key=0)
            obs = jpls.cost.sample_observation_noise(number_of_particles=jparticles.shape[1],
                                                     key=1, dtype=jnp.float64)
            kw = dict(predictive_noise=noise, observation_noise=obs)
            jsamples = jpls.predict_samples(particles=jparticles, x=x, **kw)
            tsamples = tpls.predict_samples(
                particles=carried(jparticles), x=carried(x),
                **{k: carried(v) for k, v in kw.items()})
            jsamples_np = np.asarray(jsamples)
            np.testing.assert_allclose(to_np(tsamples), jsamples_np, rtol=1e-7,
                                       atol=1e-7 * np.abs(jsamples_np).max(),
                                       err_msg=f"{model_name} {split.name}")
            if name == "mixture_likelihood":
                continue  # its cost has no predictive distribution
            jpred = jpls.cost.predict(prediction_samples=jsamples)
            tpred = tpls.cost.predict(prediction_samples=tsamples)
            for attr in ("probs", "rate", "mean", "variance"):
                if hasattr(jpred, attr):
                    np.testing.assert_allclose(to_np(getattr(tpred, attr)),
                                               np.asarray(getattr(jpred, attr)), rtol=1e-7,
                                               err_msg=f"{model_name} {split.name} {attr}")
            if name not in BANDS:
                continue
            ty = torch.from_numpy(y)
            for metric in ("nll", "mse", "mae"):
                tv = getattr(tmetrics, f"calculate_{metric}")(tpred, ty)
                jv = getattr(jmetrics, f"calculate_{metric}")(jpred, jnp.asarray(y))
                assert tv == pytest.approx(jv, rel=1e-7), (model_name, split.name, metric)
            if name == "classification":
                for metric in ("acc", "auc", "f1"):
                    tv = getattr(tmetrics, f"calculate_{metric}")(tpred.probs, ty)
                    jv = getattr(jmetrics, f"calculate_{metric}")(jpred.probs, jnp.asarray(y))
                    assert abs(tv - jv) <= 1e-12, (model_name, split.name, metric, tv, jv)


def _mixture_split(pls, particles, data, to_array):
    from experiments_torch.curves.mixture_likelihood.summarise import mode_split

    predictions = pls.predict_untransformed_samples(particles=particles,
                                                    x=to_array(np.asarray(data.train.x)))
    return mode_split("curve2", torch.as_tensor(np.asarray(predictions)),
                      torch.from_numpy(np.asarray(data.train.y)), 20.0)


def test_pls_values_within_the_band(run):
    name, root, _, jax_learned, data, port, _ = run
    if name in BANDS:
        results = os.path.join("results", "curve2")
        files = [f for f in _files(root / "jax" / results) if f.startswith("pls")]
        assert len(files) == (4 * 12 if name == "classification" else 2 * 6)
        for f in files:
            metric = f.split(os.sep)[1].rsplit("_", 1)[0]
            _, _, jv = _value(root / "jax" / results / f)
            _, _, tv = _value(root / "torch" / results / f)
            assert math.isfinite(tv), f
            if metric in ("acc", "auc", "f1"):
                assert 0 <= tv <= 1, f
            elif f.startswith("pls-ipb") and f.endswith("test.csv"):
                assert 1 / 2.5 <= tv / jv <= 2.5, f
            else:
                assert abs(tv - jv) <= BANDS[name][metric] * abs(jv), f
    elif name == "regression":
        jpls, jparticles = jax_learned["pls-onb-learned"]
        x, y = np.asarray(data.test.x), np.asarray(data.test.y)
        jmse = float(np.mean((np.asarray(
            jpls.predict(x=jnp.asarray(x), particles=jparticles, key=0).mean) - y) ** 2))
        tmse = float(torch.mean((port["pls"].predict(
            x=torch.from_numpy(x), particles=port["particles"], generator=0).mean
            - torch.from_numpy(y)) ** 2))
        assert abs(tmse - jmse) <= 0.15 * jmse
    else:
        jsplit = _mixture_split(*jax_learned["pls-onb-learned"], data, jnp.asarray)
        tsplit = _mixture_split(port["pls"], port["particles"], data, torch.from_numpy)
        assert jsplit["bimodal"] and tsplit["bimodal"]
        assert abs(tsplit["n_upper"] - jsplit["n_upper"]) <= 4
        assert abs(tsplit["est_shift"] - jsplit["est_shift"]) <= 0.12 * jsplit["est_shift"]


def _assert_carried_run_matches_jax(run):
    """The port's main on the JAX main's draws: each train_pls call's
    energies and particles, each model's chosen step size, steps run and
    trained particles, and every ``pls*`` results value at rtol 1e-7; the
    mixture's mode split and estimated shift on JAX's predictive noise."""
    name, root, records, jax_learned, data, _, _ = run
    carried = records["carried"]
    carried["carrier"].assert_runs_match(rtol=1e-7)
    results = os.path.join("results", "curve2")
    if os.path.isdir(root / "jax" / results):
        files = [f for f in _files(root / "jax" / results) if f.startswith("pls")]
        assert files
        for f in files:
            jh, ji, jv = _value(root / "jax" / results / f)
            th, ti, tv = _value(root / "carried" / results / f)
            assert (th, ti) == (jh, ji)
            np.testing.assert_allclose(tv, jv, rtol=1e-7, err_msg=f)
    if name == "mixture_likelihood":
        from experiments_torch.curves.mixture_likelihood.summarise import mode_split

        jpls, jparticles = jax_learned["pls-onb-learned"]
        port = carried["port"]
        x = np.asarray(data.train.x)
        noise = jpls.basis.sample_predictive_noise(particles=jparticles, x=jnp.asarray(x), key=0)
        y = torch.from_numpy(np.asarray(data.train.y))
        jsplit = mode_split("curve2", torch.as_tensor(np.asarray(
            jpls.predict_untransformed_samples(particles=jparticles, x=jnp.asarray(x),
                                               noise=noise))), y, 20.0)
        tsplit = mode_split("curve2", port["pls"].predict_untransformed_samples(
            particles=port["particles"], x=torch.from_numpy(x),
            noise=torch.from_numpy(np.asarray(noise))), y, 20.0)
        assert tsplit["n_upper"] == jsplit["n_upper"]
        np.testing.assert_allclose(tsplit["est_shift"], jsplit["est_shift"], rtol=1e-7)


def test_pls_values_match_jax_on_carried_draws(run):
    _assert_carried_run_matches_jax(run)


def test_precond_pls_values_match_jax_on_carried_draws(precond_run):
    _assert_carried_run_matches_jax(precond_run)
