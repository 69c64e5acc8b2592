"""The port harness's YAML reader (``experiments_torch/config.py``) against
``yaml.safe_load``: equal on every config of both harnesses, and raising on
what lies outside its subset. Also: the port's short configs differ from
their sources in depth only."""

import math
import pathlib

import pytest
import yaml

from experiments_torch.config import load_config, loads

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "experiments").rglob("config*.yaml")) + sorted(
    (ROOT / "experiments_torch").rglob("config*.yaml")
)
# the keys the short configs may cut (depth only) and their sources
DEPTH_KEYS = {("kernel", "number_of_epochs"), ("svgp", "number_of_epochs"),
              ("pls", "maximum_number_of_steps"), ("pls", "number_of_step_searches")}
SHORT = {
    "experiments_torch/uci/regression/config_precond_map_short.yaml":
        "experiments/uci/regression/config_precond_map.yaml",
    "experiments_torch/uci/classification/config_precond_smooth_short.yaml":
        "experiments/uci/classification/config_precond_smooth.yaml",
}


def _same(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(ROOT)))
def test_reader_equals_safe_load(path):
    with open(path) as f:
        expected = yaml.safe_load(f)
    assert _same(load_config(str(path)), expected)


@pytest.mark.parametrize("text", [
    "a: 1e-5\nb: 1.0e7\nc: 1.0e+7\nd: -1.0e-05\ne: .5\nf: -.inf\ng: .NaN",
    "a: yes\nb: Off\nc: TRUE\nd: ~\ne:\nf: null\ng: 0\nh: +3\ni: 1_000",
    "a: 'x # y' # comment\nb: \"q\"\nc: 'it''s'\nd: some words  # c\ne: nystrom",
    "# only a comment\n\na:\n  b:\n    c: 1\n  d:\ne: 2\n",
    "",
])
def test_scalars_resolve_as_safe_load(text):
    assert _same(loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: [1, 2]", "- a", "a:\n  - 1", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1",
    "a: |\n  text", "---\na: 1", "a: 0x1f", "a: 010", "a: 1:30", "a: 2020-01-01",
    "a: 1\na: 2", "a:\n\tb: 1", "a:\n    b: 1\n  c: 2", "true: 1", "a: b: c", "a: x#y",
    "a: \"x\\ny\"", "a: 'abc", "a: 'it''s", "a: 'x' y",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        loads(text)


@pytest.mark.parametrize("short", sorted(SHORT))
def test_short_configs_cut_depth_only(short):
    cut, source = load_config(str(ROOT / short)), load_config(str(ROOT / SHORT[short]))
    assert list(cut) == list(source)
    changed = set()
    for section in source:
        assert list(cut[section]) == list(source[section])
        for key in source[section]:
            if cut[section][key] != source[section][key]:
                changed.add((section, key))
                assert cut[section][key] < source[section][key]
    assert changed == DEPTH_KEYS
