"""The WDBC demo twin's data (``examples/classification_demo_torch.py``):
the bundled table is scikit-learn's ``load_breast_cancer``, and its numpy
split (the UCI harness's ``train_test_split``) is scikit-learn's
``train_test_split(test_size=0.2, random_state=0)``, the JAX demo's.
The demo itself takes about 30 s on the CPU; chip_smoke phase 12 runs it on
the card."""

import os
import runpy

import numpy as np
from sklearn.datasets import load_breast_cancer
from sklearn.model_selection import train_test_split

DEMO = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "examples", "classification_demo_torch.py"),
                      run_name="demo")


def test_bundled_table_is_sklearns_wdbc():
    features, target = DEMO["load_wdbc"]()
    data = load_breast_cancer()
    np.testing.assert_array_equal(features, data.data)
    np.testing.assert_array_equal(target, data.target)


def test_split_is_sklearns_train_test_split():
    rows = np.arange(569)
    train, test = train_test_split(rows, test_size=0.2, random_state=0)
    got_train, got_test, _, _ = DEMO["train_test_split"](rows, rows, test_size=0.2,
                                                         random_state=0)
    np.testing.assert_array_equal(got_train, train)
    np.testing.assert_array_equal(got_test, test)
