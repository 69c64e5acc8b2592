"""Each per-layer metric's arithmetic on a small recorded trace."""

import math

import pytest

from benchmark.harness.timing import Call, Op, Trace
from benchmark.run import HERE, load_module

US = 1000  # ns


def reader(name):
    return load_module(f"{HERE}/metrics/{name}.py", f"metric_{name.replace('.', '_')}")


@pytest.fixture
def trace():
    # two calls of 10 us of host span each, 2 units of work each; kernels
    # inside them, one overlapping another, one memcpy, and one kernel
    # outside every call
    calls = [Call(0, 10 * US, 2.0), Call(20 * US, 30 * US, 2.0)]
    device = [
        Op("ard_gram_register_kernel", 1 * US, 3 * US, "kernel"),
        Op("kernel<getrf_wo_pivot_params_<double> >", 2 * US, 5 * US, "kernel"),  # overlaps the first
        Op("Memcpy DtoH", 6 * US, 7 * US, "memcpy"),
        Op("elementwise_kernel", 21 * US, 25 * US, "kernel"),
        Op("ard_gram_register_kernel", 26 * US, 28 * US, "kernel"),
        Op("stray_kernel", 12 * US, 13 * US, "kernel"),
    ]
    host = [Op("cudaStreamSynchronize", 7 * US, 9 * US), Op("aten::linalg_eigh", 13 * US, 19 * US)]
    return Trace(device, host, calls)


def test_window_busy_and_idle(trace):
    assert trace.window_s == pytest.approx(30e-6)
    # union: [1, 5] + [6, 7] + [12, 13] + [21, 25] + [26, 28] = 4 + 1 + 1 + 4 + 2 = 12 us
    assert trace.busy_s == pytest.approx(12e-6)
    for name in ("idle_pct.updates", "idle_pct.svgp", "idle_pct.exact_gp"):
        assert reader(name).read(trace, {}) == pytest.approx(100.0 * (1 - 12 / 30))


def test_kernels_and_host(trace):
    # kernels inside the spans: 4 (the memcpy and the stray kernel are not counted)
    assert reader("kernels_per_epoch.svgp").read(trace, {}) == pytest.approx(4 / 4.0)
    assert reader("kernels_per_step.off").read(trace, {"j": 2}) == pytest.approx(4 / 2.0)
    # idle inside the spans: call 1: 10 - 5 = 5 us; call 2: 10 - 6 = 4 us
    assert reader("train_host_ms").read(trace, {}) == pytest.approx(4.5e-3)
    assert reader("factor_ms_per_epoch.svgp").read(trace, {}) == pytest.approx(3e-3 / 4.0)


def test_shares_of_peaks(trace):
    busy = 11e-6  # inside the spans
    n, m_k, d = 1000, 50, 8
    mfu = reader("updates_mfu").read(trace, {"n": n, "m_k": m_k})
    assert mfu == pytest.approx(100 * 4 * n * m_k * 4.0 / (busy * 67e12))
    gp = reader("exact_gp_mfu")
    assert gp.read(trace, {"n": n, "d": d}) == pytest.approx(
        100 * gp.epoch_ops(n, d) * 4.0 / (busy * 67e12))
    assert gp.epoch_ops(n, d) == pytest.approx(n**3 + 2 * n**2 + (7 * d + 1) * n**2)
    b2 = reader("b2_roofline.exact_gp").read(trace, {"n": n, "d": d})
    least = max(8.0 * (n * d + n * n) / 3.35e12, (3 * d + 2) * n * n / 67e12)
    assert b2 == pytest.approx(100 * least / 2e-6)


def test_nothing_to_read_reads_nothing():
    empty = Trace([], [], [Call(0, 10 * US, 1.0)])
    for name in ("kernels_per_step.off", "kernels_per_epoch.svgp", "factor_ms_per_epoch.svgp",
                 "b2_roofline.exact_gp", "updates_mfu", "exact_gp_mfu"):
        assert reader(name).read(empty, {"n": 10, "m_k": 2, "j": 1, "d": 1}) is None


def test_breakdown(trace):
    ops = dict(trace.top_device_ops())
    assert ops["ard_gram_register_kernel"] == pytest.approx(4e-6)
    gaps = dict(trace.idle_gaps(min_gap_ns=1 * US))
    # [0, 1] benchmark loop, [7, 12] sync, [13, 21] eigh, [25, 26], [28, 30]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(5e-6)
    assert gaps["aten::linalg_eigh"] == pytest.approx(8e-6)
    assert math.isclose(sum(gaps.values()), 18e-6)
