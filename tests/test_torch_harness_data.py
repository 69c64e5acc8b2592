"""The port harness's data layer against the JAX harness and scikit-learn,
on the CPU in fp64: the splits and the kNN subsample indices bit for bit,
``ExperimentData`` and exact-GP checkpoints read across both ways, the
synthetic generator byte for byte, and the port's own checkpoints."""

import hashlib
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split
from sklearn.neighbors import NearestNeighbors

from experiments import loaders as jloaders
from experiments import preprocess as jpre
from experiments import runners as jrunners
from experiments.data import ExperimentData as JExperimentData
from experiments.data import ProblemType as JProblemType
from experiments.uci import constants as jconstants
from experiments.uci import make_synthetic_datasets as jsynthetic
from experiments_torch import loaders, preprocess, runners
from experiments_torch.data import Data, ExperimentData, ProblemType
from experiments_torch.uci import constants, make_synthetic_datasets
from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_tpu.models.gaussian_process import ExactGP as JExactGP
from projected_langevin_sampling_tpu.ops.kernels import ARDKernel as JARDKernel
from tests.torch_parity import jax_onb, jax_svgp, svgp_params, to_np

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _data(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=n)


@pytest.mark.parametrize("n", [7, 100, 300, 1000, 8192])
@pytest.mark.parametrize("test_size", [0.2, 1 - (0.8 + 0.1), 0.1 / (0.1 + 0.8), 0.5])
def test_train_test_split_matches_scikit_learn(n, test_size):
    x = np.arange(2 * n, dtype=float).reshape(n, 2)
    y = np.arange(n, dtype=float)
    for seed in (0, 3):
        for ours, theirs in zip(preprocess.train_test_split(x, y, test_size, seed),
                                sk_split(x, y, test_size=test_size, random_state=seed)):
            np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n", [300, 1000])
@pytest.mark.parametrize("validation", [0.0, 0.1])
@pytest.mark.parametrize("normalise", [True, False])
def test_set_up_experiment_matches_jax(n, validation, normalise):
    x, y = _data(n)
    kwargs = dict(name="d", problem_type=None, seed=4, x=x, y=y, train_data_percentage=0.8,
                  normalise=normalise, validation_data_percentage=validation)
    ours = preprocess.set_up_experiment(**dict(kwargs, problem_type=ProblemType.REGRESSION),
                                        device="cpu")
    theirs = jpre.set_up_experiment(**dict(kwargs, problem_type=JProblemType.REGRESSION))
    assert (ours.y_mean, ours.y_std) == (theirs.y_mean, theirs.y_std)
    for part in ("full", "train", "test", "validation"):
        a, b = getattr(ours, part), getattr(theirs, part)
        if b is None:
            assert a is None
            continue
        assert a.x.device == CPU and a.name == b.name
        np.testing.assert_array_equal(to_np(a.x), to_np(b.x))
        np.testing.assert_array_equal(to_np(a.y), to_np(b.y))


@pytest.mark.parametrize("n", [50, 333])
def test_split_regression_data_matches_jax(n):
    x, y = _data(n)
    ours = preprocess.split_regression_data(2, torch.as_tensor(x), torch.as_tensor(y), 0.6, 0.2, 0.2)
    theirs = jpre.split_regression_data(2, x, y, 0.6, 0.2, 0.2)
    for a, b in zip(ours, theirs, strict=True):
        assert a.device == CPU
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("intervals", [(3, 30), (5, 64)])
def test_split_regression_data_intervals_matches_jax(intervals):
    x, y = _data(640, d=1)
    yu = y ** 2
    ours = preprocess.split_regression_data_intervals(1, torch.as_tensor(x), torch.as_tensor(y),
                                                      *intervals, y_untransformed=torch.as_tensor(yu))
    theirs = jpre.split_regression_data_intervals(1, x, y, *intervals, y_untransformed=yu)
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(to_np(a), to_np(b))


# (rows, D, neighbours): scikit-learn's tree query (k < n / 2, D <= 15) and
# its brute-force query (k >= n / 2, or D > 15)
@pytest.mark.parametrize("n, d, k", [(240, 8, 100), (1000, 8, 300), (1000, 8, 600),
                                     (6553, 8, 5000), (200, 34, 50)])
def test_subsample_indices_match_jax_and_scikit_learn(n, d, k):
    x, _ = _data(n, d)
    for seed in (0, 1, 2):
        ours = runners.subsample_data_indices(torch.as_tensor(x), k, seed)
        np.testing.assert_array_equal(ours, jrunners.subsample_data_indices(x, k, seed))
        centre = x[np.random.default_rng(seed).integers(n)][None]
        theirs = NearestNeighbors(n_neighbors=k).fit(x).kneighbors(centre, return_distance=False)
        np.testing.assert_array_equal(ours, theirs[0])
    assert runners.subsample_data_indices(x, n + 1, 0) is None


def test_load_subsample_data_gathers_the_rows():
    x, y = _data(120)
    data = Data(x=torch.as_tensor(x), y=torch.as_tensor(y))
    sub = runners.load_subsample_data(data, 40, seed=3)
    idx = runners.subsample_data_indices(x, 40, 3)
    np.testing.assert_array_equal(to_np(sub.x), x[idx])
    np.testing.assert_array_equal(to_np(sub.y), y[idx])
    assert runners.load_subsample_data(data, 500, seed=3) is data


def _experiment(n=60):
    x, y = _data(n)
    return jpre.set_up_experiment("d", JProblemType.REGRESSION, 1, x, y, 0.8,
                                  validation_data_percentage=0.1)


def test_experiment_data_read_across_both_ways(tmp_path):
    jdata = _experiment()
    jdata.save(str(tmp_path / "j.pkl"))
    ours = ExperimentData.load(str(tmp_path / "j.pkl"), ProblemType.REGRESSION, device="cpu")
    ours.save(str(tmp_path / "t.pkl"))
    back = JExperimentData.load(str(tmp_path / "t.pkl"), JProblemType.REGRESSION)
    assert (ours.name, ours.y_mean, ours.y_std) == (jdata.name, jdata.y_mean, jdata.y_std)
    for part in ("full", "train", "test", "validation"):
        for field in ("x", "y"):
            expected = to_np(getattr(getattr(jdata, part), field))
            np.testing.assert_array_equal(to_np(getattr(getattr(ours, part), field)), expected)
            np.testing.assert_array_equal(to_np(getattr(getattr(back, part), field)), expected)
    assert ours.full.y_untransformed is None and back.train.y_untransformed is None
    f32 = ExperimentData.load(str(tmp_path / "j.pkl"), ProblemType.REGRESSION, device="cpu",
                              dtype=torch.float32)
    assert f32.train.x.dtype == torch.float32


def test_exact_gp_checkpoint_read_across_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    jgp = JExactGP(mean_constant=jnp.asarray(0.3),
                   kernel=JARDKernel(jnp.asarray([0.7, 1.3]), jnp.asarray(1.4)),
                   noise=jnp.asarray(0.05), x_train=jnp.asarray(rng.normal(size=(9, 2))),
                   y_train=jnp.asarray(rng.normal(size=9)))
    jloaders.save_ard_exact_gp_model(str(tmp_path / "j.pkl"), jgp, [1.0, 0.5])
    ours, losses = loaders.load_ard_exact_gp_model(str(tmp_path / "j.pkl"), device="cpu")
    assert losses == [1.0, 0.5]
    loaders.save_ard_exact_gp_model(str(tmp_path / "t.pkl"), ours, losses)
    back, back_losses = jloaders.load_ard_exact_gp_model(str(tmp_path / "t.pkl"))
    assert back_losses == losses
    for model in (ours, back):
        for name in ("mean_constant", "noise", "x_train", "y_train"):
            np.testing.assert_array_equal(to_np(getattr(model, name)), to_np(getattr(jgp, name)))
        np.testing.assert_array_equal(to_np(model.kernel.lengthscales), [0.7, 1.3])
        np.testing.assert_array_equal(to_np(model.kernel.outputscale), 1.4)
    x = rng.normal(size=(4, 2))
    np.testing.assert_allclose(to_np(ours.predict_y(torch.as_tensor(x)).mean),
                               to_np(jgp.predict_y(jnp.asarray(x)).mean), rtol=1e-12)


def test_port_pls_svgp_and_inducing_point_checkpoints_round_trip(tmp_path):
    import projected_langevin_sampling_torch as pt
    from tests.torch_parity import basis_params

    jbasis, _, x, y = jax_onb(scaling="nystrom", mean_constant=0.25)
    basis = convert.orthonormal_basis_from_numpy(basis_params(jbasis), device="cpu")
    noise = pt.StudentTPredictiveNoise(df=4.0, scale=0.3)
    pls = pt.PLS(basis.replace(additional_predictive_noise_distribution=noise),
                 pt.GaussianCost(y_train=torch.as_tensor(y), observation_noise=torch.tensor(0.1)))
    u = torch.randn(basis.approximation_dimension, 5, dtype=torch.float64)
    loaders.save_pls(str(tmp_path / "p.pkl"), u, pls.observation_noise, 1e-3, 40,
                     mean_constant=0.25, basis=pls.basis)
    target = pt.PLS(basis.replace(eigenvalues=basis.eigenvalues * 2, mean_constant=0.0,
                                  additional_predictive_noise_distribution=noise),
                    pt.GaussianCost(y_train=torch.as_tensor(y), observation_noise=torch.tensor(9.)))
    particles, obs, lr, epochs = loaders.load_pls(str(tmp_path / "p.pkl"), pls=target)
    assert (obs, lr, epochs) == (pytest.approx(0.1), 1e-3, 40)
    np.testing.assert_array_equal(to_np(particles), to_np(u))
    assert float(target.observation_noise) == pytest.approx(0.1)
    assert target.basis.mean_constant == 0.25 and target.basis.scaling == "nystrom"
    assert target.basis.additional_predictive_noise_distribution is noise
    np.testing.assert_array_equal(to_np(target.basis.eigenvalues), to_np(basis.eigenvalues))

    for likelihood in ("gaussian", "student_t", "bernoulli"):
        jsvgp, _, _ = jax_svgp(likelihood, pls=True)
        svgp = convert.svgp_from_numpy(svgp_params(jsvgp), device="cpu")
        loaders.save_svgp(str(tmp_path / f"{likelihood}.pkl"), svgp, [2.0], 0.01)
        back, losses, rate = loaders.load_svgp(str(tmp_path / f"{likelihood}.pkl"),
                                               svgp.likelihood, device="cpu")
        assert (losses, rate) == ([2.0], 0.01)
        for name in ("mean_constant", "x_induce", "variational_mean", "variational_chol"):
            np.testing.assert_array_equal(to_np(getattr(back, name)), to_np(getattr(svgp, name)))
        assert type(back.likelihood) is type(svgp.likelihood)
        assert type(back.kernel) is type(svgp.kernel)
    with pytest.raises(TypeError):
        loaders.load_svgp(str(tmp_path / "gaussian.pkl"), pt.BernoulliLikelihood(), device="cpu")

    induce = Data(x=torch.as_tensor(x[:4]), y=torch.as_tensor(y[:4]), name="induce")
    loaders.save_inducing_points(str(tmp_path / "i.pkl"), induce)
    back = loaders.load_inducing_points(str(tmp_path / "i.pkl"), device="cpu")
    assert back.name == "induce" and back.y_untransformed is None
    np.testing.assert_array_equal(to_np(back.x), x[:4])


def test_schemas_equal_the_jax_harness():
    assert [e.value for e in constants.RegressionDatasetSchema] == [
        e.value for e in jconstants.RegressionDatasetSchema]
    assert [e.value for e in constants.ClassificationDatasetSchema] == [
        e.value for e in jconstants.ClassificationDatasetSchema]
    names = [e.value for e in jconstants.RegressionDatasetSchema] + [
        e.value for e in jconstants.ClassificationDatasetSchema] + list(
        jconstants.EXTRA_REGRESSION_DATASETS) + list(jconstants.EXTRA_CLASSIFICATION_DATASETS)
    for name in names:
        ours, theirs = constants.resolve_schema(name), jconstants.resolve_schema(name)
        assert ours.input_column_names == theirs.input_column_names
        assert ours.output_column_name == theirs.output_column_name
    with pytest.raises(KeyError):
        constants.resolve_schema("nope")


@pytest.mark.parametrize("rows", [37, 1000])
def test_synthetic_generator_writes_the_jax_harness_bytes(tmp_path, rows, capsys):
    jsynthetic.main(rows, str(tmp_path / "jax"))
    make_synthetic_datasets.main(rows, str(tmp_path / "torch"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch")) and len(files) == 14
    for name in files:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    make_synthetic_datasets.main(rows, str(tmp_path / "two"), names=["rice", "kin8nm"])
    assert sorted(os.listdir(tmp_path / "two")) == ["kin8nm.csv", "rice.csv"]
    assert (tmp_path / "two" / "rice.csv").read_bytes() == (tmp_path / "jax" / "rice.csv").read_bytes()
    if rows == 1000:
        # the pins of the repo's datasets README; ionosphere's predates the
        # generator as it stands, in both harnesses
        pins = json.loads((ROOT / "experiments/uci/datasets/checksums.json").read_text())
        for name in files:
            digest = hashlib.sha256((tmp_path / "torch" / name).read_bytes()).hexdigest()
            assert (digest == pins[name[:-4]]) == (name != "ionosphere.csv"), name
