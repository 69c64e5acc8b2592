"""The port's results pipeline (``experiments_torch/aggregate_seeds.py`` and
``experiments_torch/make_results_summary.py``) against the JAX scripts
(``experiments/aggregate_seeds.py``, ``experiments/make_results_summary.py``),
on the same trees, on the CPU.

The trees are small per-seed outputs made from a numpy seed in ``tmp_path``.
The UCI and curve-metric trees have one layout for both packages (the JAX
script's ``ROOT/experiments`` is the port's ``root``); the files the JAX
script reads from ``results/`` (the mixture tables, the Poisson study's long
CSV, the gap CSVs, the profiler sweeps) are written by the port's own
writers and placed where each package reads them; the curve checkpoints are
written by each package's ``save_pls`` from the same numbers. The JAX
functions run with ``make_results_summary.ROOT`` monkeypatched to the tree.

Every table line, win and tie count and significance line must be the JAX
text exactly (``evidence``); the prose differs by design. The long CSV must
give back every per-seed value exactly. The last tests render the UCI
sections from the reference's own ``results/uci_metrics_long.csv`` (the JAX
script's clean-clone path; the port's ``archive=``).
"""

import math
import os
import shutil
import tempfile

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from experiments import aggregate_seeds as jagg
from experiments import make_results_summary as jmrs
from experiments.loaders import save_pls as jax_save_pls
from experiments_torch import aggregate_seeds as tagg
from experiments_torch import make_results_summary as tmrs
from experiments_torch.curves.mixture_likelihood.summarise import summary_table
from experiments_torch.curves.poisson_regression.study import merge_rows
from experiments_torch.loaders import save_pls as torch_save_pls
from experiments_torch.metrics import _write_table, concatenate_seed
from experiments_torch.profiler.main import write_sweep
from experiments_torch.uci.classification.analyse_gap import write_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_LONG = os.path.join(REPO, "results", "uci_metrics_long.csv")
EVIDENCE = ("|", "Summary:", "Paired-by-seed significance", "models share", "- `", "Rollup (")


def evidence(text: str, headings: bool = False) -> list[str]:
    """The table, count and verdict lines of a section (with ``headings``
    its ``###`` lines too, the mechanism headings aside)."""
    keep = EVIDENCE + (("###",) if headings else ())
    return [line for line in text.splitlines()
            if line.startswith(keep) and not line.startswith("### Mechanism")]


def write_metric(root, task, protocol, seed, dataset, model, metric, value, split="test"):
    """One per-seed metric CSV, as the mains write it."""
    path = os.path.join(root, "uci", task, protocol, str(seed), "results", dataset, model)
    os.makedirs(path, exist_ok=True)
    _write_table(os.path.join(path, f"{metric}_{split}.csv"), [model], [(dataset, [value])])


def jax_frame(rows) -> pd.DataFrame:
    return pd.DataFrame(rows, columns=jagg._COLUMNS)


def jax_rows(frame: pd.DataFrame) -> list[tuple]:
    return [(d, mo, me, int(s), float(v)) for d, mo, me, s, v in frame.itertuples(index=False)]


def same_rows(a, b) -> bool:
    """The same keys in the same order and the same values, within what
    pandas' default C parser (the JAX script's reader) drops: it reads at
    most 17 digits, a leading zero counted, and rounds as it scales, so it
    misses the text's value by a few 1e-16 of max(1, |v|). The port parses
    with ``float``, exactly."""
    return len(a) == len(b) and all(
        x[:4] == y[:4] and (abs(x[4] - y[4]) <= 1e-15 * max(1.0, abs(y[4]))
                            or (math.isnan(x[4]) and math.isnan(y[4])))
        for x, y in zip(a, b))


# --- aggregate_seeds ---------------------------------------------------------------
def _render_rows(case: str, rng) -> list[tuple]:
    rows = []
    if case == "missing_cells":
        for d, models in (("wine_uci", ("pls-onb", "svgp")), ("breast_wdbc", ("pls-onb",)),
                          ("kin8nm", ("svgp", "svgp-temper"))):
            for m in models:
                rows += [(d, m, "nll", s, float(rng.normal())) for s in range(3)]
    elif case == "single_seed":
        rows = [("iris_binary", "pls-onb", "nll", 4, 0.11), ("iris_binary", "svgp", "nll", 4,
                                                              float(rng.normal()))]
    elif case == "first_seen_order":
        # svgp-student-conformalise is met first in the sorted (dataset, model)
        # groups of dataset "a", before pls-onb of dataset "b"
        for d, m in (("b", "pls-onb"), ("a", "svgp-student-conformalise"), ("b", "svgp"),
                     ("c", "a-model"), ("a", "svgp")):
            rows += [(d, m, metric, s, float(rng.normal() * 10.0 ** rng.integers(-3, 2)))
                     for metric in ("mse", "nll") for s in rng.choice(10, 4, replace=False)]
    elif case == "nan_values":
        rows = [("d", "pls-onb", "nll", s, v) for s, v in enumerate([0.5, math.nan, 0.25])]
        rows += [("d", "svgp", "nll", 0, math.nan), ("e", "svgp", "nll", 0, 1.0)]
    else:  # "many": ten seeds of rounded values near the 4th-decimal edges
        for d in ("x", "y", "z"):
            for m in ("pls-onb", "svgp", "pls-student-onb"):
                rows += [(d, m, "nll", s, round(float(rng.normal()), int(rng.integers(4, 7))))
                         for s in range(10)]
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


@pytest.mark.parametrize("case", ["missing_cells", "single_seed", "first_seen_order",
                                  "nan_values", "many"])
@pytest.mark.parametrize("metrics", [None, ["nll", "absent", "mse"]])
def test_render_matches_jax(case, metrics):
    rows = _render_rows(case, np.random.default_rng(len(case)))
    expected = jagg.render(jax_frame(rows), metrics)
    assert tagg.render(tagg.Long(rows), metrics) == expected


def test_render_of_nothing_matches_jax():
    assert tagg.render(tagg.Long()) == jagg.render(jax_frame([])) == "(no results found)\n"


@pytest.mark.parametrize("seed", range(2))
def test_pandas_arithmetic(seed):
    """The groupby mean (Kahan), the groupby std (Welford) and the Series
    mean and std (numpy's pairwise sums) bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        v = rng.normal(size=int(rng.integers(1, 25))) * 10 ** rng.uniform(-3, 3) \
            + 10 ** rng.uniform(-2, 4)
        if rng.uniform() < 0.2:
            v[rng.integers(len(v))] = np.nan
        stats = pd.DataFrame({"g": 0, "v": v}).groupby("g")["v"].agg(["mean", "std"]).iloc[0]
        series = pd.Series(v)
        for got, expected in ((tagg.group_mean(v), stats["mean"]),
                              (tagg.group_std(v), stats["std"]),
                              (tagg.series_mean(v), series.mean()),
                              (tagg.series_std(v), series.std())):
            assert got == expected or (math.isnan(got) and math.isnan(expected))


def _collect_tree(root, rng):
    for seed in (0, 1, 3):
        for dataset in ("wine_uci", "diabetes_sklearn"):
            for model in ("pls-onb", "svgp"):
                for metric in ("nll", "mse"):
                    for split in ("test", "train"):
                        write_metric(root, "classification", "outputs_x", seed, dataset, model,
                                     metric, float(rng.normal()), split)
    bad = os.path.join(root, "uci", "classification", "outputs_x", "0", "results", "wine_uci",
                       "svgp")
    with open(os.path.join(bad, "broken_test.csv"), "w") as f:  # no dataset column
        f.write("name,svgp\nwine_uci,0.5\n")
    with open(os.path.join(bad, "empty_test.csv"), "w") as f:
        f.write("")
    with open(os.path.join(bad, "nan_test.csv"), "w") as f:
        f.write("dataset,svgp\nwine_uci,\n")
    return os.path.join(root, "uci", "classification", "outputs_x")


def test_collect_matches_jax(tmp_path):
    tree = _collect_tree(str(tmp_path), np.random.default_rng(0))
    for split in ("test", "train", "validation"):
        assert same_rows(tagg.collect(tree, split).rows(), jax_rows(jagg.collect(tree, split)))
    names = set(tagg.collect(tree, "test")["metric"])
    assert names == {"nll", "mse", "nan"}


def test_collect_archive_union_matches_jax(tmp_path, monkeypatch):
    """On-disk rows first, then the archive's rows of the tree's task,
    protocol and split that the disk lacks."""
    tree = _collect_tree(str(tmp_path), np.random.default_rng(1))
    archive = str(tmp_path / "long.csv")
    with open(archive, "w") as f:
        f.write("task,protocol,split,dataset,model,metric,seed,value\n")
        f.write("classification,outputs_x,test,wine_uci,pls-onb,nll,0,123.0\n")  # on disk
        f.write("classification,outputs_x,test,wine_uci,pls-onb,nll,7,0.25\n")
        f.write("classification,outputs_x,test,iris_binary,svgp,acc,2,\n")
        f.write("classification,outputs_x,train,wine_uci,pls-onb,nll,7,9.0\n")
        f.write("classification,outputs_y,test,wine_uci,pls-onb,nll,8,9.0\n")
        f.write("regression,outputs_x,test,wine_uci,pls-onb,nll,9,9.0\n")
    monkeypatch.setattr(jagg, "_ROOT", str(tmp_path))
    monkeypatch.setattr(jagg, "_LONG_CSV", archive)
    got = tagg.collect(tree, "test", archive=archive)
    assert same_rows(got.rows(), jax_rows(jagg.collect(tree, "test")))
    on_disk = got.where(dataset="wine_uci", model="pls-onb", metric="nll", seed=0)["value"]
    assert len(on_disk) == 1 and on_disk[0] != 123.0
    assert len(got) == len(tagg.collect(tree, "test")) + 2
    # an empty tree reads the archive alone
    empty = str(tmp_path / "absent" / "uci" / "classification" / "outputs_x")
    assert same_rows(tagg.collect(empty, "test", archive=archive).rows(),
                     [("wine_uci", "pls-onb", "nll", 0, 123.0),
                      ("wine_uci", "pls-onb", "nll", 7, 0.25),
                      ("iris_binary", "svgp", "acc", 2, math.nan)])


def test_collect_reads_no_reference_row_by_default():
    """A tree under the repo named as a reference protocol: the JAX collect
    unions it with results/uci_metrics_long.csv, the port's does not."""
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="summary_test_", dir=os.path.join(REPO, "build"))
    try:
        write_metric(scratch, "classification", "outputs_precond_smooth", 0, "wine_uci",
                     "pls-onb", "nll", 0.5)
        tree = os.path.join(scratch, "uci", "classification", "outputs_precond_smooth")
        assert len(jagg.collect(tree, "test")) > 1
        assert tagg.collect(tree, "test").rows() == [("wine_uci", "pls-onb", "nll", 0, 0.5)]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


# --- the UCI sections -------------------------------------------------------------
def _headline_counts(tmp_path, counts):
    root = str(tmp_path / "experiments")
    for protocol, n in counts.items():
        for i in range(n):
            write_metric(root, "classification", protocol, i, "ds", "pls-onb", "nll", 0.5)
    return root


@pytest.mark.parametrize("counts,expected", [
    ({}, None),
    ({"outputs_precond": 3}, "outputs_precond"),
    ({"outputs_precond": 3, "outputs_precond_map": 3}, "outputs_precond_map"),
    ({"outputs_precond_map": 3, "outputs_precond_smooth": 3}, "outputs_precond_smooth"),
    ({"outputs_precond_smooth": 3, "outputs_precond_map": 5}, "outputs_precond_map"),
    ({"outputs_precond_smooth": 19, "outputs_precond_map": 20}, "outputs_precond_smooth"),
    ({"outputs_precond_smooth": 18, "outputs_precond_map": 20}, "outputs_precond_map"),
    ({"outputs_precond_smooth": 18, "outputs_precond_map": 18, "outputs_precond": 20},
     "outputs_precond"),
])
def test_headline_dir_matches_jax(tmp_path, monkeypatch, counts, expected):
    root = _headline_counts(tmp_path, counts)
    monkeypatch.setattr(jmrs, "ROOT", str(tmp_path))
    jax_dir, port_dir = jmrs._headline_dir("classification"), tmrs._headline_dir(
        "classification", root)
    assert (jax_dir and os.path.basename(jax_dir)) == expected
    assert (port_dir and os.path.basename(port_dir)) == expected


def _uci_tree(root: str) -> None:
    """Both tasks' headline, ablation, toggle and nystrom trees. Per dataset
    the paired deltas make (classification): a significant PLS win, a tie
    (equal values), a non-significant row, and a significant SVGP win (the
    losses the attribution reads); regression: a PLS and an SVGP win. Each
    protocol: (seeds, metrics, splits, the datasets if not all)."""
    rng = np.random.default_rng(7)
    plans = {  # dataset: (mean delta pls - svgp, spread of the deltas)
        "classification": {"breast_wdbc": (0.05, 0.01), "wine_uci": (0.0, 0.0),
                           "digits_even": (0.01, 0.2), "synthetic_c": (-0.2, 0.05)},
        "regression": {"diabetes_sklearn": (0.03, 0.01), "kin8nm": (-0.1, 0.02)},
    }
    every, two, both, test = ("nll", "acc", "auc", "f1"), ("nll", "acc"), ("test", "train"), \
        ("test",)
    # the toggle trees hold the datasets the attribution reads only
    loss = {"classification": ("breast_wdbc",), "regression": ("diabetes_sklearn",)}
    protocols = {
        "classification": {
            "outputs_precond_smooth": (5, two, both, None),
            "outputs_precond_map": (5, two, test, None),
            "outputs_precond": (5, two, test, None), "outputs": (3, every, both, None),
            "outputs_precond_m0": (4, ("nll",), test, None),
            "outputs_precond_smooth_j1000": (4, two, test, loss["classification"]),
            "outputs_precond_smooth_t2": (5, two, test, loss["classification"]),
            "outputs_precond_smooth_eq": (5, two, test, loss["classification"])},
        "regression": {
            "outputs_precond_map": (5, ("nll", "mse"), both, None),
            "outputs": (5, ("nll", "mse"), test, None),
            "outputs_nystrom": (4, ("nll", "mse"), test, None),
            "outputs_precond_map_t2": (5, ("nll", "mse"), test, loss["regression"])},
    }
    pls_only = {"outputs_precond_map_t2"}
    for task, plan in plans.items():
        for protocol, (n_seeds, metrics, splits, only) in protocols[task].items():
            shift = rng.normal(scale=0.02)
            for dataset, (delta, spread) in plan.items():
                if only is not None and dataset not in only:
                    continue
                for seed in range(n_seeds):
                    for metric in metrics:
                        base = round(float(rng.uniform(0.1, 1.0)), 6)
                        sign = 1.0 if metric in ("nll", "mse", "mae") else -1.0
                        d = sign * (delta + shift + spread * rng.normal()) if spread else 0.0
                        pairs = [("pls-onb", base + d), ("svgp", base)]
                        if task == "regression":
                            pairs += [("pls-student-onb", base + 0.5 * d),
                                      ("svgp-student", base)]
                        for model, value in pairs:
                            if model.startswith("svgp") and protocol in pls_only:
                                continue
                            for split in splits:
                                write_metric(root, task, protocol, seed, dataset, model, metric,
                                             value + (split == "train") * 0.1, split)


def _gap_rows(rng, datasets, seeds, validated=True):
    rows = []
    for dataset in datasets:
        for seed in seeds:
            row = {"dataset": dataset, "seed": seed}
            for key in ("pls_nll", "svgp_nll", "pls_mc_std", "pls_nll_recal", "svgp_nll_recal",
                        "pls_latent_var", "pls_proj_var", "pls_noise_var", "svgp_latent_var",
                        "pls_nll_extended", "pls_proj_var_extended", "pls_nll_temper",
                        "svgp_nll_temper", "pls_temper_s", "svgp_temper_s"):
                row[key] = float(rng.uniform(0.05, 2.0))
            row["delta"] = row["pls_nll"] - row["svgp_nll"]
            row["extra_steps"] = 1000
            row["validated"] = bool(validated if seed else not validated)
            rows.append(row)
    return rows


@pytest.fixture(scope="module")
def uci_tree(tmp_path_factory):
    """(JAX ROOT, port root, gap directory) of one tree for both."""
    top = tmp_path_factory.mktemp("uci")
    root = str(top / "experiments")
    _uci_tree(root)
    gap_dir = str(top / "results")
    os.makedirs(gap_dir)
    rng = np.random.default_rng(3)
    write_rows(os.path.join(gap_dir, "gap_attribution.csv"),
               _gap_rows(rng, ["breast_wdbc", "synthetic_c"], range(4)))
    for tag in ("eq", "t2"):
        write_rows(os.path.join(gap_dir, f"gap_attribution_{tag}.csv"),
                   _gap_rows(rng, ["breast_wdbc"], range(3)))
    return str(top), root, gap_dir


SECTIONS = {
    "headline_classification": (lambda: jmrs.headline_vs_svgp_section(),
                                lambda r, g: tmrs.headline_vs_svgp_section(root=r)),
    "headline_regression": (
        lambda: jmrs.headline_vs_svgp_section("regression", ("nll", "mse")),
        lambda r, g: tmrs.headline_vs_svgp_section("regression", ("nll", "mse"), root=r)),
    "headline_student_t": (
        lambda: jmrs.headline_vs_svgp_section("regression", ("nll", "mse"),
                                              pls_model="pls-student-onb",
                                              svgp_model="svgp-student"),
        lambda r, g: tmrs.headline_vs_svgp_section("regression", ("nll", "mse"),
                                                   pls_model="pls-student-onb",
                                                   svgp_model="svgp-student", root=r)),
    "real_data_rollup": (lambda: jmrs.real_data_rollup_section(),
                         lambda r, g: tmrs.real_data_rollup_section(r)),
    "uci_headline_regression": (
        lambda: jmrs.uci_section("x", "experiments/uci/regression/outputs_precond_map",
                                 ["nll", "mse", "absent"], "note"),
        lambda r, g: tmrs.uci_section("x", tmrs._uci(r, "regression", "outputs_precond_map"),
                                      ["nll", "mse", "absent"], "note")),
    "uci_classification": (
        lambda: jmrs.uci_section("x", "experiments/uci/classification/outputs",
                                 ["nll", "acc", "auc", "f1"], "note"),
        lambda r, g: tmrs.uci_section("x", tmrs._uci(r, "classification", "outputs"),
                                      ["nll", "acc", "auc", "f1"], "note")),
    "nystrom": (lambda: jmrs.nystrom_section(), lambda r, g: tmrs.nystrom_section(r)),
    "ablation_classification": (lambda: jmrs.ablation_section(),
                                lambda r, g: tmrs.ablation_section(root=r)),
    "ablation_regression": (lambda: jmrs.ablation_section("regression"),
                            lambda r, g: tmrs.ablation_section("regression", root=r)),
    "loss_attribution_nll": (lambda: jmrs.loss_attribution_section(),
                             lambda r, g: tmrs.loss_attribution_section(root=r, gap_dir=g)),
    "loss_attribution_acc": (
        lambda: jmrs.loss_attribution_section("classification", metric="acc",
                                              lower_better=False),
        lambda r, g: tmrs.loss_attribution_section("classification", metric="acc",
                                                   lower_better=False, root=r, gap_dir=g)),
    "loss_attribution_regression": (
        lambda: jmrs.loss_attribution_section("regression"),
        lambda r, g: tmrs.loss_attribution_section("regression", root=r)),
}


@pytest.mark.parametrize("name", list(SECTIONS))
def test_uci_section_matches_jax(uci_tree, monkeypatch, name):
    top, root, gap_dir = uci_tree
    monkeypatch.setattr(jmrs, "ROOT", top)
    jax_fn, port_fn = SECTIONS[name]
    expected, got = jax_fn(), port_fn(root, gap_dir)
    assert expected and got
    headings = not name.startswith("loss")
    assert evidence(got, headings) == evidence(expected, headings)


def test_sections_cover_wins_ties_and_ns(uci_tree):
    """The tree gives the head-to-head a significant win each way, a tie
    and a non-significant row, and the attribution a loss with a mechanism."""
    _, root, gap_dir = uci_tree
    text = tmrs.headline_vs_svgp_section(root=root)
    for winner in ("**pls** (sig)", "svgp (sig)", "tie (ns)", "(ns)"):
        assert winner in text
    attribution = tmrs.loss_attribution_section(root=root, gap_dir=gap_dir)
    assert "- `breast_wdbc` (n=3): delta" in attribution
    assert "under **spread-equilibration** (n=2 validated seeds)" in attribution


def test_dump_metrics_long_round_trip(uci_tree, tmp_path, monkeypatch):
    """Every per-seed value back exactly from the long CSV; the same rows as
    the JAX script's long CSV; the tables from the long CSV alone (an empty
    root) equal to those from the tree."""
    top, root, _ = uci_tree
    path = str(tmp_path / "out" / "uci_metrics_long.csv")
    n = tmrs.dump_metrics_long(path, root)
    rows = tagg.read_metrics_long(path)
    assert n == len(rows) > 500
    for task, protocol, split, dataset, model, metric, seed, value in rows:
        file = os.path.join(root, "uci", task, protocol, str(seed), "results", dataset, model,
                            f"{metric}_{split}.csv")
        with open(file) as f:
            assert value == float(f.read().splitlines()[1].split(",")[1])
    monkeypatch.setattr(jmrs, "ROOT", str(tmp_path / "jax"))
    os.makedirs(tmp_path / "jax" / "results")
    shutil.copytree(os.path.join(root, "uci"), tmp_path / "jax" / "experiments" / "uci")
    jmrs.dump_metrics_long()
    jax_long = pd.read_csv(tmp_path / "jax" / "results" / "uci_metrics_long.csv")
    assert [tuple(r[:7]) for r in rows] == [
        (t, p, s, d, mo, me, int(se)) for t, p, s, d, mo, me, se, _ in
        jax_long.itertuples(index=False)]
    empty = str(tmp_path / "empty")
    for name, from_long in (
            ("real_data_rollup", lambda: tmrs.real_data_rollup_section(empty, path)),
            ("loss_attribution_nll", lambda: tmrs.loss_attribution_section(root=empty,
                                                                           archive=path))):
        assert evidence(from_long(), True) == evidence(SECTIONS[name][1](root, None), True)


# --- the curve, multi-rank and profiler sections ------------------------------------
CURVES = ("curve1", "curve2", "curve10")


@pytest.fixture(scope="module")
def curve_trees(tmp_path_factory):
    """A JAX tree (ROOT: results/ files, JAX checkpoints) and a port tree
    (root: the port's layout) of the same numbers."""
    top = tmp_path_factory.mktemp("curves")
    jax_root, port_root = str(top / "jax"), str(top / "port")
    jexp = os.path.join(jax_root, "experiments")
    rng = np.random.default_rng(11)
    cells = {(task, curve, model, metric): float(rng.uniform(0, 3))
             for task, models, metrics in (
                 ("classification", ("pls-onb-sigmoid", "svgp-c"), ("nll", "acc")),
                 ("poisson_regression", ("pls-onb", "pls-ipb"), ("nll", "mse")))
             for curve in CURVES for model in models for metric in metrics
             if not (curve == "curve10" and model in ("svgp-c", "pls-ipb") and metric != "nll")}
    for root in (jexp, port_root):
        for (task, curve, model, metric), value in cells.items():
            path = os.path.join(root, "curves", task, "outputs", "results", curve, model)
            os.makedirs(path, exist_ok=True)
            _write_table(os.path.join(path, f"{metric}_test.csv"), [model], [(curve, [value])])
    for dirname in ("outputs", "outputs_precond"):
        for curve in CURVES:
            lr = None if (curve == "curve10" and dirname == "outputs") else float(
                10 ** rng.uniform(-6, -2))
            noise, epochs = float(rng.uniform(0.01, 0.1)), int(rng.integers(100, 10 ** 6))
            particles = rng.normal(size=(4, 3))
            path = os.path.join(jexp, "curves", "regression", dirname, "models", curve)
            os.makedirs(path)
            jax_save_pls(os.path.join(path, "pls-onb.pkl"), jnp.asarray(particles),
                         jnp.asarray(noise), lr, epochs)
            path = os.path.join(port_root, "curves", "regression", dirname, "models", curve)
            os.makedirs(path)
            torch_save_pls(os.path.join(path, "pls-onb.pkl"), torch.from_numpy(particles),
                           torch.tensor(noise), lr, epochs)
    os.makedirs(os.path.join(jax_root, "results"))
    for suffix in ("", "_precond_wide"):
        table = summary_table([
            {"curve": c, "n_lower": int(rng.integers(0, 50)), "n_upper": int(rng.integers(0, 50)),
             "est_shift": float(rng.uniform(0, 25)), "bimodal": bool(rng.uniform() < 0.7)}
            for c in CURVES[:2]] + [{"curve": "curve10", "no_candidate": True}], 20.0)
        with open(os.path.join(jax_root, "results", f"mixture_summary{suffix}.md"), "w") as f:
            f.write(table)
        path = os.path.join(port_root, "curves", "mixture_likelihood", f"outputs{suffix}")
        os.makedirs(path)
        with open(os.path.join(path, "mixture_summary.md"), "w") as f:
            f.write(table)
    study = os.path.join(port_root, "poisson_study_long.csv")
    rows = []
    for curve in CURVES:
        for seed in range(6 if curve != "curve2" else 1):
            for model in ("pls-onb", "pls-onb-m0", "pls-onb-hs", "pls-ipb", "svgp-gaussian"):
                if model == "pls-onb-hs" and seed > 3:
                    continue
                for metric in ("nll", "rate_rmse"):
                    for split in ("test", "train"):
                        rows.append({"curve": curve, "seed": seed, "model": model,
                                     "metric": metric, "split": split,
                                     "value": float(rng.normal(
                                         0.3 if model == "svgp-gaussian" else 0.0, 0.1))})
    merge_rows(rows, study)
    shutil.copy(study, os.path.join(jax_root, "results", "poisson_study_long.csv"))
    sweep = os.path.join(port_root, "profiler", "outputs")
    os.makedirs(sweep)
    for axis, values in (("N", (100, 1000, 500)), ("T", (10.0, 100.0))):
        write_sweep(os.path.join(sweep, f"{axis}.csv"), [
            [axis, v, s, m, float(rng.uniform(1, 100))]
            for v in values for s in range(3) for m in ("svgp", "pls-onb")])
    shutil.copytree(sweep, os.path.join(jax_root, "results", "profiler_cpu"))
    for root in (jexp, port_root):
        path = os.path.join(root, "uci", "regression", "outputs_parallel")
        for model in ("pls-onb", "pls-onb-temper", "svgp"):
            for metric in ("nll", "mse"):
                write_metric(root, "regression", "outputs_parallel", 0, "energy_cooling", model,
                             metric, float(np.random.default_rng(len(model + metric)).normal()))
        concatenate_seed(path, 0, ["energy_cooling"], ["pls-onb", "pls-onb-temper", "svgp"],
                         ["nll", "mse"])
    return jax_root, port_root, study


CURVE_SECTIONS = {
    "curves": (jmrs.curves_section, lambda r, s: tmrs.curves_section(r)),
    "curve_classification": (jmrs.curve_classification_section,
                             lambda r, s: tmrs.curve_classification_section(r)),
    "poisson": (jmrs.poisson_section, lambda r, s: tmrs.poisson_section(r)),
    "poisson_study": (jmrs.poisson_study_section, lambda r, s: tmrs.poisson_study_section(s)),
    "mixture": (jmrs.mixture_section, lambda r, s: tmrs.mixture_section(r)),
    "multichip": (jmrs.multichip_section, lambda r, s: tmrs.multichip_section(r)),
    "profiler": (jmrs.profiler_section, lambda r, s: tmrs.profiler_section(r)),
}


@pytest.mark.parametrize("name", list(CURVE_SECTIONS))
def test_curve_section_matches_jax(curve_trees, monkeypatch, name):
    jax_root, port_root, study = curve_trees
    monkeypatch.setattr(jmrs, "ROOT", jax_root)
    jax_fn, port_fn = CURVE_SECTIONS[name]
    expected, got = jax_fn(), port_fn(port_root, study)
    assert evidence(expected) and evidence(got) == evidence(expected)
    if name == "curve_classification":
        wins = expected.split("PLS wins NLL on ")[1].split(" curves")[0]
        assert f"PLS wins NLL on {wins} curves" in got


@pytest.mark.parametrize("name", list(CURVE_SECTIONS))
def test_curve_section_without_its_tree_is_empty(tmp_path, name):
    assert CURVE_SECTIONS[name][1](str(tmp_path), str(tmp_path / "none.csv")) == ""


def test_summary_writes_beside_out_and_never_into_results(uci_tree, tmp_path):
    _, root, gap_dir = uci_tree
    out = tmp_path / "summary" / "RESULTS.md"
    text = tmrs.main(["--root", root, "--out", str(out), "--gap_dir", gap_dir,
                      "--provenance", "the CPU"])
    assert out.read_text() == text and "Produced on: the CPU." in text
    assert (tmp_path / "summary" / "uci_metrics_long.csv").exists()
    for forbidden in (os.path.join(REPO, "results", "x.md"), os.path.join(REPO, "RESULTS.md")):
        with pytest.raises(ValueError):
            tmrs.main(["--root", root, "--out", forbidden])
    for word in ("TPU", "v5e", "round-3", "round-4"):
        assert word not in text


# --- the reference's record, read by both packages -------------------------------------
REFERENCE_SECTIONS = {
    "real_data_rollup": (jmrs.real_data_rollup_section,
                         lambda r: tmrs.real_data_rollup_section(r, REFERENCE_LONG)),
    "ablation_classification": (jmrs.ablation_section,
                                lambda r: tmrs.ablation_section(root=r, archive=REFERENCE_LONG)),
}


@pytest.mark.parametrize("name", list(REFERENCE_SECTIONS))
def test_reference_record_renders_as_jax(tmp_path, name):
    """The reference's 43,000-row long CSV (RESULTS.md's source) through
    both packages: the JAX script's clean-clone path, the port's archive."""
    jax_fn, port_fn = REFERENCE_SECTIONS[name]
    expected = jax_fn()
    assert evidence(expected)
    assert evidence(port_fn(str(tmp_path)), True) == evidence(expected, True)
