"""The device idle booked to the program's ``pls.`` spans
(``harness/spans.py``) and the per-layer metrics that read it, on a small
recorded trace."""

import pytest

from benchmark.harness.spans import idle_by_span
from benchmark.harness.timing import Call, Op, Trace
from benchmark.run import HERE, load_module

US = 1000  # ns
CELLS = {"updates": ("pls.train_pls", "pls.train_pls.readback"),
         "svgp": ("pls.fit_svgp", "pls.fit.readback"),
         "exact_gp": ("pls.fit_exact_gp", "pls.fit.readback")}


def reader(name):
    return load_module(f"{HERE}/metrics/{name}.py", f"metric_{name.replace('.', '_')}")


def recorded(outer: str, readback: str) -> Trace:
    """Two calls of a program with nested spans. Call 1, [0, 20] us: idle
    [0, 3], [5, 8], [11, 13], [16, 20]; call 2, [30, 40]: idle [30, 32] and
    [38, 39] (its last kernel runs past the call's end, a kernel of [25, 31]
    starts before it and is not the call's)."""
    calls = [Call(0, 20 * US, 2.0), Call(30 * US, 40 * US, 2.0)]
    device = [Op("k", a * US, b * US, "kernel")
              for a, b in ((3, 5), (8, 11), (13, 16), (25, 31), (32, 38), (39, 42))]
    spans = [(outer, 1, 19), ("pls.run_training", 2, 17), ("pls.run_training.warmup", 2, 4),
             ("pls.run_training.capture", 4, 7), ("pls.run_training.chunk", 7, 9),
             ("pls.run_training.sync", 9, 12), ("pls.run_training.close", 12, 14),
             ("aten::add_", 15, 16), (readback, 17, 18),
             (outer, 31, 39), (readback, 38, 39)]
    return Trace(device, [Op(n, a * US, b * US) for n, a, b in spans], calls)


@pytest.mark.parametrize("cell", list(CELLS))
def test_idle_is_booked_to_the_innermost_span(cell):
    outer, readback = CELLS[cell]
    booked = idle_by_span(recorded(outer, readback))
    expected = {"unspanned": 3, outer: 3, "pls.run_training.warmup": 1,
                "pls.run_training.capture": 2, "pls.run_training.chunk": 1,
                "pls.run_training.sync": 1, "pls.run_training.close": 1,
                "pls.run_training": 1, readback: 2}
    assert booked == {name: us * US for name, us in expected.items()}


@pytest.mark.parametrize("cell", list(CELLS))
def test_metrics_read_the_booked_idle(cell):
    trace = recorded(*CELLS[cell])
    # per call: warm-up 1 + capture 2; sync 1 + close 1 + read-back 2; unspanned 3
    assert reader(f"capture_idle_ms.{cell}").read(trace, {}) == pytest.approx(1.5e-3)
    assert reader(f"drain_idle_ms.{cell}").read(trace, {}) == pytest.approx(2e-3)
    assert reader(f"unspanned_idle_ms.{cell}").read(trace, {}) == pytest.approx(1.5e-3)


def test_booked_idle_sums_to_train_host_ms():
    trace = recorded(*CELLS["updates"])
    booked = idle_by_span(trace)
    host_ms = reader("train_host_ms").read(trace, {})
    assert host_ms == pytest.approx(7.5e-3)
    assert sum(booked.values()) / len(trace.calls) / 1e6 == pytest.approx(host_ms, rel=1e-12)


def test_a_trace_without_program_spans_reads_nothing():
    trace = Trace([Op("k", 1 * US, 3 * US, "kernel")], [Op("aten::add_", 4 * US, 6 * US)],
                  [Call(0, 10 * US, 1.0)])
    assert idle_by_span(trace) is None
    for cell in CELLS:
        for kind in ("capture", "drain", "unspanned"):
            assert reader(f"{kind}_idle_ms.{cell}").read(trace, {}) is None
