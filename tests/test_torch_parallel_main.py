"""The port's UCI regression main on ``config_parallel.yaml``'s 2 x 4 mesh:
eight gloo ranks on the CPU (``experiments_torch/uci/regression/launch_cpu_ranks.py``,
one spawn for the whole file), against the same main in one process
without ``pls.parallel``.

The data are the port generator's synthetic ``energy_cooling`` cut to 240
rows; the config is the JAX config cut in depth only (GP and SVGP epochs,
SVGP learning rates, step-size candidates of 500 and 1000 steps). The
single-process main runs on one host thread, as each rank does: with more
threads the train-split predictive covariance's eigh sums in another order
and the train metrics move by up to 6e-9.

- Every rank exits 0 and trains its share (pls-onb on the spectral tier,
  pls-student-onb on ``off``); only rank 0's files exist: the tree is the
  single-process main's, file for file, and no rank's private copy is left.
- Every metric file and both PLS checkpoints match the single-process main
  at rtol 1e-9, the tolerance ``tests/test_torch_parallel.py`` holds sharded
  training to (the column shards' energies are sums in another order).
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

from experiments_torch.uci import make_synthetic_datasets
from experiments_torch.uci.regression import launch_cpu_ranks
from experiments_torch.uci.regression import main as tmain

ROWS, RANKS, RTOL = 240, 8, 1e-9
CONFIG = "experiments/uci/regression/config_parallel.yaml"
# the depth cut: (the source's line, the cut line)
CUTS = [("  number_of_epochs: 100000\n  subsample_size",
         "  number_of_epochs: 30\n  subsample_size"),
        ("  maximum_number_of_steps: 10000000.0\n  number_of_step_searches: 5",
         "  maximum_number_of_steps: 1.0e+3\n  number_of_step_searches: 2"),
        ("  number_of_epochs: 100000\n  batch_size: 5000\n  learning_rate_upper",
         "  number_of_epochs: 10\n  batch_size: 5000\n  learning_rate_upper"),
        ("  number_of_learning_rate_searches: 3", "  number_of_learning_rate_searches: 2")]
MESH = "  parallel:\n    data: 2\n    particles: 4\n"


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top) for d, _, fs in os.walk(top)
                  for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_main")
    datasets, logs, scratch = root / "datasets", root / "logs", root / "tmp"
    logs.mkdir()
    scratch.mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_datasets.main(ROWS, str(datasets), names=["energy_cooling"])
    with open(CONFIG) as f:
        text = f.read()
    for old, new in CUTS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert text.count(MESH) == 1
    (root / "parallel.yaml").write_text(text)
    (root / "single.yaml").write_text(text.replace(MESH, ""))
    args = ["--dataset", "energy_cooling", "--data_seed", "0", "--datasets_dir", str(datasets)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(scratch))  # the ranks' private copies
        mp.setenv("OMP_NUM_THREADS", "1")
        rc = launch_cpu_ranks.launch(
            RANKS, ["--config_path", str(root / "parallel.yaml"), "--outputs_dirname",
                    str(root / "parallel"), *args], timeout=600, log_dir=str(logs))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            tmain.cli(["--config_path", str(root / "single.yaml"), "--outputs_dirname",
                       str(root / "single"), "--device", "cpu", *args])
    finally:
        torch.set_num_threads(threads)
    return root, rc


def test_every_rank_exits_zero_and_trains_its_share(runs):
    root, rc = runs
    assert rc == 0
    for rank in range(RANKS):
        log = (root / "logs" / f"rank{rank}.log").read_text()
        assert "[search pls-onb]" in log and "tier=spectral" in log, rank
        assert "[search pls-student-onb]" in log and "tier=off" in log, rank
        # only rank 0 scores the models and fits the SVGPs
        assert ("calibration and metrics" in log) == (rank == 0), rank
        assert ("[search svgp]" in log) == (rank == 0), rank


def test_only_rank_zero_files_exist(runs):
    root, _ = runs
    parallel, single = _files(root / "parallel"), _files(root / "single")
    assert parallel == single and len(parallel) > 100
    assert not [f for f in os.listdir(root / "tmp") if f.startswith("uci_regression_rank")]


def test_parallel_main_without_a_group_raises(tmp_path):
    config = {"parallel": {"data": 2, "particles": 4}}
    with pytest.raises(ValueError, match="torchrun"):
        tmain.main(0, "energy_cooling", {}, {}, {}, config, {}, {}, str(tmp_path), device="cpu")


def _cells(path):
    with open(path) as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    return rows[0], [r[0] for r in rows[1:]], np.array(
        [[float(c) if c else np.nan for c in r[1:]] for r in rows[1:]])


@pytest.mark.parametrize("model", tmain.MODEL_NAMES)
def test_metric_files_match_the_single_process_main(runs, model):
    root, _ = runs
    results = os.path.join("0", "results", "energy_cooling", model)
    files = _files(root / "single" / results)
    assert files
    for f in files:
        sh, si, sv = _cells(root / "single" / results / f)
        ph, pi, pv = _cells(root / "parallel" / results / f)
        assert (ph, pi) == (sh, si), f
        np.testing.assert_allclose(pv, sv, rtol=RTOL, err_msg=f)


def test_joined_tables_match_the_single_process_main(runs):
    root, _ = runs
    results = os.path.join("0", "results")
    files = sorted(f for f in os.listdir(root / "single" / results) if f.endswith(".csv"))
    # the tables concatenate_seed joins: the metrics every model writes
    assert files == sorted(f"{m}_{s}.csv" for m in ("mae", "mse", "nll") for s in ("train", "test"))
    for f in files:
        sh, si, sv = _cells(root / "single" / results / f)
        ph, pi, pv = _cells(root / "parallel" / results / f)
        assert (ph, pi) == (sh, si), f
        np.testing.assert_allclose(pv, sv, rtol=RTOL, err_msg=f)


@pytest.mark.parametrize("model", ["pls-onb", "pls-student-onb"])
def test_checkpoints_match_the_single_process_main(runs, model):
    root, _ = runs
    path = os.path.join("0", "models", "energy_cooling", f"{model}.pkl")
    with open(root / "single" / path, "rb") as f:
        single = pickle.load(f)
    with open(root / "parallel" / path, "rb") as f:
        parallel = pickle.load(f)
    assert parallel["particles"].shape == (single["particles"].shape[0], 100)
    np.testing.assert_allclose(parallel["particles"], single["particles"], rtol=RTOL, atol=1e-12)
    assert (parallel["best_lr"], parallel["number_of_epochs"]) == (single["best_lr"],
                                                                   single["number_of_epochs"])
