"""The port's ``experiments_torch/uci/classification/analyse_gap.py`` against
the JAX script (``experiments/uci/classification/analyse_gap.py``), on the
CPU in fp64.

- The numpy helpers (``_logit``, ``_nll``, ``_recalibrate``,
  ``_temper_pls``, ``_temper_svgp``) and the per-point decomposition give
  the JAX script's values at rtol 1e-12 on the same inputs.
- The port's classification main runs on ``iris_binary`` from the port's
  ``fetch_datasets --sklearn-bundled`` (its short config cut further in
  depth: one Dirichlet GP of 10 epochs a class, two step-size candidates of
  at most 300 steps, two SVGP learning rates of 5 epochs); ``analyse_gap``
  on its checkpoints passes the validation gate (the main's own
  ``nll_test.csv``, tolerance 1e-3 nats), writes its report and CSV, and a
  second probe replaces the CSV's row. A checkpoint whose particles are
  perturbed fails the gate.
"""

import contextlib
import io
import os
import pickle
import shutil

import numpy as np
import pytest

from experiments.uci.classification import analyse_gap as jgap
from experiments_torch.config import load_config
from experiments_torch.uci import fetch_datasets
from experiments_torch.uci.classification import analyse_gap as tgap
from experiments_torch.uci.classification import main as tmain
from tests.torch_parity import one_thread

RTOL = 1e-12
CONFIG = "experiments_torch/uci/classification/config_precond_smooth_short.yaml"
DATASET = "iris_binary"


def _inputs(seed=0, n=60, j=20):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=n) < 0.5).astype(float)
    p = 1 / (1 + np.exp(-(2.0 * (2 * y - 1) + rng.normal(size=n))))
    q = np.clip(p + 0.1 * rng.normal(size=n), 0.01, 0.99)
    f = rng.normal(size=(n, j)) + (2 * y - 1)[:, None]
    return y, p, q, f


@pytest.mark.parametrize("seed", [0, 1])
def test_logit_and_nll_match_jax(seed):
    y, p, q, _ = _inputs(seed)
    edges = np.concatenate([p, [0.0, 1.0, 1e-15, 1 - 1e-15]])
    np.testing.assert_allclose(tgap._logit(edges), jgap._logit(edges), rtol=RTOL)
    assert tgap._nll(p, y) == pytest.approx(jgap._nll(p, y), rel=RTOL)
    assert tgap._nll(q, y) == pytest.approx(jgap._nll(q, y), rel=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_recalibrate_matches_jax(seed):
    y, p, q, _ = _inputs(seed)
    got, expected = tgap._recalibrate(p, y, q), jgap._recalibrate(p, y, q)
    np.testing.assert_allclose(got[0], expected[0], rtol=RTOL)
    assert got[1:] == pytest.approx(expected[1:], rel=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_tempers_match_jax(seed):
    y, p, q, f = _inputs(seed)
    yt, _, _, ft = _inputs(seed + 10)
    assert tgap._temper_pls(f, y, ft, yt) == pytest.approx(jgap._temper_pls(f, y, ft, yt),
                                                           rel=RTOL)
    mu, var = f.mean(axis=1), f.var(axis=1)
    mut, vart = ft.mean(axis=1), ft.var(axis=1)
    assert tgap._temper_svgp(mu, var, y, mut, vart, yt) == pytest.approx(
        jgap._temper_svgp(mu, var, y, mut, vart, yt), rel=RTOL)


def _jax_tail_share(pls_probs, svgp_probs, y):
    """The JAX script's per-point decomposition (analyse_gap.py:236-243)."""
    pp = np.clip(np.asarray(pls_probs, dtype=np.float64), 1e-12, 1 - 1e-12)
    ps = np.clip(np.asarray(svgp_probs, dtype=np.float64), 1e-12, 1 - 1e-12)
    lp_p = y * np.log(pp) + (1 - y) * np.log1p(-pp)
    lp_s = y * np.log(ps) + (1 - y) * np.log1p(-ps)
    d = lp_s - lp_p
    k = max(1, int(0.05 * len(d)))
    return float(np.sort(d)[-k:].sum() / d.sum()) if d.sum() > 0 else float("nan")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_point_decomposition_matches_jax(seed):
    y, p, q, _ = _inputs(seed)
    for a, b in ((q, p), (p, q)):  # SVGP ahead, and behind (NaN)
        np.testing.assert_allclose(tgap.tail_share(a, b, y), _jax_tail_share(a, b, y),
                                   rtol=RTOL)


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    root = tmp_path_factory.mktemp("analyse_gap")
    config = load_config(CONFIG)
    config["kernel"].update(number_of_epochs=10, number_of_iterations=1)
    config["pls"].update(number_of_step_searches=2, maximum_number_of_steps=300)
    config["svgp"].update(number_of_epochs=5, number_of_learning_rate_searches=2)
    sections = {k: f"{k}_config" for k in ("kernel", "pls", "svgp", "metrics")}
    sections.update(data="data_config", inducing_points="inducing_points_config")
    base = str(root / "outputs")
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        fetch_datasets.write_sklearn_bundled(str(root / "datasets"))
        tmain.main(data_seed=0, dataset_name=DATASET, outputs_path=base,
                   datasets_dir=str(root / "datasets"), device="cpu",
                   **{arg: config[k] for k, arg in sections.items()})
        rows = tgap.run(base, [DATASET], [0, 1], config, str(root / "report" / "gap.md"),
                        device="cpu")
    return root, base, config, rows


def test_the_mains_checkpoints_pass_the_gate(probed):
    root, _, _, rows = probed
    (row,) = rows  # seed 1 has no checkpoints: skipped
    assert row["validated"] and row["dataset"] == DATASET and row["seed"] == 0
    assert abs(row["pls_nll"] - row["pls_nll_recorded"]) <= 1e-3
    assert abs(row["svgp_nll"] - row["svgp_nll_recorded"]) <= 1e-3
    for key in ("pls_mc_std", "pls_nll_recal", "svgp_nll_recal", "pls_latent_var",
                "pls_proj_var", "svgp_latent_var", "pls_nll_temper", "svgp_nll_temper",
                "pls_nll_extended", "pls_proj_var_extended"):
        assert np.isfinite(row[key]), key
    assert row["extra_steps"] >= 1000
    report = (root / "report" / "gap.md").read_text()
    assert f"## {DATASET}" in report and "Means over 1 seeds" in report
    (saved,) = tgap.read_rows(str(root / "report" / "gap.csv"))
    assert saved["validated"] is True and saved["pls_nll"] == row["pls_nll"]


def test_a_second_probe_replaces_its_row(probed):
    root, base, config, _ = probed
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        tgap.run(base, [DATASET], [0], config, str(root / "report" / "gap.md"), device="cpu")
    assert len(tgap.read_rows(str(root / "report" / "gap.csv"))) == 1


def test_a_perturbed_checkpoint_fails_the_gate(probed, tmp_path):
    root, base, config, _ = probed
    shutil.copytree(base, tmp_path / "outputs")
    path = tmp_path / "outputs" / "0" / "models" / DATASET / "pls-onb.pkl"
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["particles"] = payload["particles"] + 1.0
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        (row,) = tgap.run(str(tmp_path / "outputs"), [DATASET], [0], config,
                          str(tmp_path / "gap.md"), device="cpu")
    assert not row["validated"]
    assert abs(row["pls_nll"] - row["pls_nll_recorded"]) > 1e-3
    # the SVGP side still matches
    assert abs(row["svgp_nll"] - row["svgp_nll_recorded"]) <= 1e-3
    assert os.path.exists(tmp_path / "gap.md")
