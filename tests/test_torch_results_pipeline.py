"""The port's results pipeline end to end on the CPU, and ``analyse_gap``'s
validation gate on its long CSV.

- The port's regression main (pls-onb and svgp) on a 300-row synthetic
  kin8nm for data seeds 0 and 1, at the depth of the harness tests (2
  subsample GPs of 100 rows and 30 epochs, 2 step-size candidates of at
  most 2000 steps, 2 SVGP learning rates of 10 epochs), fp64, into the
  headline protocol's tree; then ``aggregate_seeds`` and
  ``make_results_summary`` over it: the head-to-head names the set with
  n = 2, the long CSV gives back every per-seed value exactly, and the
  tables rendered from the long CSV alone are those rendered from the tree.
- ``analyse_gap.recorded_nll`` and ``gate`` read the long CSV's row of the
  tree's protocol when it has one, and the main's per-seed file otherwise.
"""

import contextlib
import io
import os

import pytest

from experiments_torch import aggregate_seeds, make_results_summary
from experiments_torch.config import load_config
from experiments_torch.metrics import _write_table
from experiments_torch.uci import make_synthetic_datasets
from experiments_torch.uci.classification import analyse_gap
from experiments_torch.uci.regression import main as regression
from tests.torch_parity import one_thread

CONFIG = "experiments_torch/uci/regression/config_precond_map_short.yaml"
CUTS = {"kernel": dict(number_of_iterations=2, number_of_epochs=30, subsample_size=100),
        "pls": dict(number_of_step_searches=2, maximum_number_of_steps=2000),
        "svgp": dict(number_of_learning_rate_searches=2, number_of_epochs=10)}
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    top = tmp_path_factory.mktemp("pipeline")
    root, datasets = str(top / "experiments_torch"), str(top / "datasets")
    config = load_config(CONFIG)
    for section, values in CUTS.items():
        config[section].update(values)
    tree = os.path.join(root, "uci", "regression", "outputs_precond_map")
    with contextlib.redirect_stdout(io.StringIO()), one_thread():
        make_synthetic_datasets.main(300, datasets, names=["kin8nm"])
        for seed in SEEDS:
            regression.main(data_seed=seed, dataset_name="kin8nm", outputs_path=tree,
                            datasets_dir=datasets, device="cpu", models_filter={"pls-onb", "svgp"},
                            **{f"{k}_config": v for k, v in config.items()})
        out = str(top / "summary" / "RESULTS.md")
        text = make_results_summary.main(["--root", root, "--out", out, "--provenance", "CPU"])
    return root, tree, text, str(top / "summary" / "uci_metrics_long.csv")


def test_head_to_head_names_the_set_over_both_seeds(pipeline):
    root, tree, text, _ = pipeline
    long = aggregate_seeds.collect(tree, "test")
    assert sorted(set(long["seed"])) == list(SEEDS)
    table = aggregate_seeds.render(long, ["mse"])
    assert "| kin8nm " in table and "(2)" in table
    head = text.split("## PLS vs SVGP head-to-head (headline regression protocol")[1]
    rows = [line for line in head.split("\n## ")[0].splitlines() if line.startswith("| kin8nm")]
    assert len(rows) == 2  # nll and mse
    for row in rows:
        assert row.count("(2)") == 2


def test_long_csv_round_trip_is_exact(pipeline):
    root, tree, _, long_csv = pipeline
    rows = aggregate_seeds.read_metrics_long(long_csv)
    assert {r[1] for r in rows} == {"outputs_precond_map"}
    assert {r[2] for r in rows} == {"train", "test"}
    for task, protocol, split, dataset, model, metric, seed, value in rows:
        path = os.path.join(tree, str(seed), "results", dataset, model, f"{metric}_{split}.csv")
        with open(path) as f:
            text = f.read().splitlines()[1].split(",")[1]
        assert value == float(text) or (text == "" and value != value)
    assert len(rows) == sum(len(aggregate_seeds.collect(tree, s)) for s in ("train", "test"))
    empty = os.path.join(os.path.dirname(root), "empty")
    assert make_results_summary.real_data_rollup_section(empty, long_csv) == \
        make_results_summary.real_data_rollup_section(root)
    assert make_results_summary.headline_vs_svgp_section(
        "regression", ("nll", "mse"), root=empty, archive=long_csv) == \
        make_results_summary.headline_vs_svgp_section("regression", ("nll", "mse"), root=root)


@pytest.fixture
def classification_tree(tmp_path):
    """The main's per-seed nll files of two seeds, and the long CSV of them."""
    root = str(tmp_path / "root")
    base = os.path.join(root, "uci", "classification", "outputs_precond_smooth")
    for seed, (pls, svgp) in enumerate(((0.125, 0.25), (0.5, 0.0625))):
        for model, value in (("pls-onb", pls), ("svgp", svgp)):
            path = os.path.join(base, str(seed), "results", "wine_uci", model)
            os.makedirs(path)
            _write_table(os.path.join(path, "nll_test.csv"), [model], [("wine_uci", [value])])
    long_csv = str(tmp_path / "uci_metrics_long.csv")
    make_results_summary.dump_metrics_long(long_csv, root)
    return base, long_csv


def test_gap_gate_reads_the_long_csv(classification_tree, tmp_path):
    base, long_csv = classification_tree
    assert analyse_gap.recorded_nll(base, "wine_uci", 1, "pls-onb", long_csv) == 0.5
    # a long CSV whose value differs from the per-seed file's is the one read
    edited = str(tmp_path / "edited.csv")
    with open(long_csv) as f, open(edited, "w") as g:
        g.write(f.read().replace("wine_uci,pls-onb,nll,1,0.5", "wine_uci,pls-onb,nll,1,0.75"))
    assert analyse_gap.recorded_nll(base, "wine_uci", 1, "pls-onb", edited) == 0.75
    row = {"dataset": "wine_uci", "seed": 1, "pls_nll": 0.5, "svgp_nll": 0.0625}
    assert analyse_gap.gate(dict(row), base, 1e-3)["validated"]
    assert analyse_gap.gate(dict(row), base, 1e-3, long_csv)["validated"]
    gated = analyse_gap.gate(dict(row), base, 1e-3, edited)
    assert not gated["validated"] and gated["pls_nll_recorded"] == 0.75


def test_gap_gate_falls_back_to_the_per_seed_files(classification_tree, tmp_path):
    base, long_csv = classification_tree
    other = str(tmp_path / "other.csv")
    with open(long_csv) as f, open(other, "w") as g:  # the rows of another protocol
        g.write(f.read().replace("outputs_precond_smooth", "outputs_precond_map"))
    assert analyse_gap.recorded_nll(base, "wine_uci", 0, "svgp", other) == 0.25
    assert analyse_gap.recorded_nll(base, "wine_uci", 0, "svgp") == 0.25
    assert analyse_gap.recorded_nll(base, "wine_uci", 5, "svgp", other) != \
        analyse_gap.recorded_nll(base, "wine_uci", 5, "svgp", other)  # NaN: neither has it
