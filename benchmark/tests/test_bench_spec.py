"""Every cell of BENCHMARK.json resolves by name, and the file keeps to the
benchmark's contract on names, units, bounds and keys."""

import json
import os
import re

import pytest

from benchmark.run import HERE, ROOT, Spec

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = Spec(BENCH, cell)
    entry = spec.entry()
    assert hasattr(entry, "Cell") and callable(entry.end_to_end)
    names = {m["name"] for m in spec.end_to_end}
    assert names == {"setup_s", entry.END_TO_END}
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in names
    assert spec.limits and all(v > 0 for v in spec.limits.values())
    assert spec.chips == 1


def test_names_units_and_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for group, allowed in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert set(e) == allowed and NAME.match(e["name"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
        assert c["reduced"] == []
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_metric_file_is_named_in_the_benchmark():
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
