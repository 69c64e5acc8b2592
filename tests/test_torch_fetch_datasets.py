"""The offline modes of the port's ``experiments_torch/uci/fetch_datasets.py``
against the JAX script's (``experiments/uci/fetch_datasets.py``), which
reads the same tables through scikit-learn and pandas.

- ``--sklearn-bundled``: the seven frames have the JAX script's headers, row
  counts and values (abs 1e-13: the z-scores are the same operations on the
  same floats), and their bytes carry the JAX script's sha256 pins
  (``experiments/uci/datasets/checksums.json``).
- The raw tables in the repo are scikit-learn's own files.
- ``--synthetic`` writes the port generator's stand-ins; the download mode
  raises, naming the network.
"""

import contextlib
import csv
import io
import os

import numpy as np
import pytest

from experiments.uci import fetch_datasets as jfetch
from experiments_torch.uci import fetch_datasets as tfetch

NAMES = list(tfetch.SKLEARN_ROWS)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    with contextlib.redirect_stdout(io.StringIO()):
        jfetch.write_sklearn_bundled(str(jdir))
        rows = tfetch.write_sklearn_bundled(str(tdir))
    return jdir, tdir, rows


def _read(path):
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    return header, np.array(body, dtype=float)


@pytest.mark.parametrize("name", NAMES)
def test_frames_match_the_jax_script(written, name):
    jdir, tdir, rows = written
    jheader, jvalues = _read(jdir / f"{name}.csv")
    theader, tvalues = _read(tdir / f"{name}.csv")
    assert theader == jheader
    assert tvalues.shape == jvalues.shape and rows[name] == jvalues.shape[0]
    np.testing.assert_allclose(tvalues, jvalues, rtol=0, atol=1e-13)


def test_frames_carry_the_jax_pins(written):
    _, tdir, _ = written
    assert tfetch.verify(str(tdir), tfetch.JAX_PINS, NAMES) == {n: True for n in NAMES}
    assert tfetch.main(["--verify", "--out", str(tdir), "--only", *NAMES]) == 0


def test_raw_tables_are_scikit_learns_files():
    sklearn_data = os.path.join(os.path.dirname(__import__("sklearn.datasets").datasets.__file__),
                                "data")
    for name in ("breast_cancer.csv", "diabetes_data_raw.csv.gz", "diabetes_target.csv.gz",
                 "digits.csv.gz", "iris.csv", "wine_data.csv"):
        assert (tfetch.sha256(os.path.join(tfetch.SKLEARN_DATA, name))
                == tfetch.sha256(os.path.join(sklearn_data, name))), name


def test_zscore_of_a_constant_column_divides_by_one():
    np.testing.assert_array_equal(tfetch.zscore(np.full(5, 3.0)), np.zeros(5))


def test_synthetic_delegates_and_download_raises(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        assert tfetch.main(["--synthetic", "--out", str(tmp_path)]) == 0
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".csv")]) == 14
    with pytest.raises(SystemExit, match="network"):
        tfetch.main(["--out", str(tmp_path)])
