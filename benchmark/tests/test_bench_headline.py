"""The ``headline_classification.train`` cell, whose kernel (B3) draws its
Langevin normals itself.

On the CPU: the Philox mirror that rebuilds those normals (Random123's known
answers, the kernel's counters and Box-Muller, the seed ``train_pls`` draws),
and the plain reference held against the port's ``general_fused`` tier fed
the mirror's normals, at a tiny size: the sound run agrees at fp64 rounding,
the TF32 control, a run with the smoothing dropped, a stuck run, a run on
half of the rows and one altered number come out not correct.
On the card: B3's own normals against the mirror, and a short traced run of
the whole check with the cell's per-layer metrics."""

import copy
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness.timing import Call, Op, Trace
from benchmark.reference import pls_philox
from benchmark.run import HERE, ROOT, Spec, load_module

CELL = "headline_classification.train"
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
SPEC = Spec(BENCH, CELL)
METRICS = [m["name"] for m in SPEC.per_layer]

# Random123's known answers for philox4x32_10 (kat_vectors): counter, key, output
F = 0xFFFFFFFF
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((F, F, F, F), (F, F), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
SEEDS = [0, 12345, 2**31 + 7, 2**62 - 1]


def scalar_philox(ctr, key):
    """Philox4x32-10 on Python integers, word by word."""
    x, y, z, w = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * x, 0xCD9E8D57 * z
        x, y, z, w = (p1 >> 32) ^ y ^ k0, p1 & F, (p0 >> 32) ^ w ^ k1, p0 & F
        k0, k1 = (k0 + 0x9E3779B9) & F, (k1 + 0xBB67AE85) & F
    return x, y, z, w


def scalar_normal(seed: int, t: int, r: int, c: int) -> float:
    """The normal of update ``t`` at row ``r``, column ``c``, from the
    kernel's counter (c // 4, r, t, 1) and its Box-Muller pairs."""
    words = scalar_philox((c // 4, r, t, 1), (seed & F, seed >> 32))
    a, b = words[2 * ((c % 4) // 2):][:2]
    radius = math.sqrt(-2.0 * math.log(((a >> 8) + 1) * 2.0**-24))
    angle = 2.0 * math.pi * ((b >> 8) + 1) * 2.0**-24
    return radius * (math.cos(angle) if c % 2 == 0 else math.sin(angle))


@pytest.mark.parametrize("ctr,key,expected", KNOWN)
def test_philox_known_answers(ctr, key, expected):
    assert tuple(int(v) for v in pls_philox.philox4x32_10(ctr, key)) == expected
    assert scalar_philox(ctr, key) == expected


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_follow_the_kernels_counters(seed):
    m, j, first, steps = 5, 10, 3, 4  # J not a multiple of 4: a partial group
    z = pls_philox.normals(seed, m, j, first, steps, "cpu")
    assert z.shape == (steps, m, j) and z.dtype == torch.float64
    for t in range(steps):
        for r in range(m):
            for c in range(j):
                assert float(z[t, r, c]) == pytest.approx(scalar_normal(seed, first + t, r, c),
                                                          rel=1e-12, abs=1e-12)


def test_normals_stay_on_the_asked_device():
    """Every intermediate lies on the device asked for (``meta`` stands in
    for the card: a tensor left on the CPU would raise)."""
    z = pls_philox.normals(2**40 + 1, 3, 6, 0, 2, torch.device("meta"))
    assert z.device.type == "meta" and z.shape == (2, 3, 6)


def test_the_mirror_copies_the_kernels_layout():
    """The counter, the key and the uniform the mirror copies, as the
    kernel's sources state them."""
    csrc = os.path.join(ROOT, "projected_langevin_sampling_torch", "csrc")
    with open(os.path.join(csrc, "general_train.cu")) as f:
        kernel = f.read()
    with open(os.path.join(csrc, "philox.cuh")) as f:
        philox = f.read()
    assert ("plst::normals4(make_uint4((uint32_t)((j0 + c) / 4), (uint32_t)r, (uint32_t)step, 1u)"
            in " ".join(kernel.split()))
    assert "make_uint2((uint32_t)seed, (uint32_t)(seed >> 32))" in philox
    assert "__uint2float_rn((bits >> 8) + 1u) * 5.9604644775390625e-08f" in philox
    assert "box_muller(bits.x, bits.y, z[0], z[1]);" in philox
    assert "box_muller(bits.z, bits.w, z[2], z[3]);" in philox


def test_the_kernels_seed_is_the_calls_first_draw(monkeypatch):
    """``philox_seed`` is the seed ``train_pls`` hands the kernel."""
    import projected_langevin_sampling_torch.training as training

    cell = tiny_cell()
    seen = []

    def spy(*args, **kwargs):
        seen.append(kwargs["seed"])
        return general_train(*args, **kwargs)

    general_train = training.general_train
    monkeypatch.setattr(training, "general_train", spy)
    cell.call(0)
    assert seen == [cell.philox_seed(0)]


def test_tf32_rounding():
    one = 1.0
    x = torch.tensor([one, one + 2.0**-10, one + 2.0**-11, one + 2.0**-12, -(one + 2.0**-11), 3e-5],
                     dtype=torch.float32)
    out = pls_philox.tf32(x)
    assert out[:5].tolist() == [one, one + 2.0**-10, one + 2.0**-10, one, -(one + 2.0**-10)]
    bits = out.view(torch.int32)
    assert bool(torch.all(bits & 0x1FFF == 0))
    assert float(abs(out[5] - x[5]) / x[5]) <= 2.0**-11


US = 1000  # ns


def reader(name):
    return load_module(f"{HERE}/metrics/{name}.py", f"metric_{name.replace('.', '_')}")


def recorded(spans: bool = True) -> Trace:
    """Two calls of 10 us, 2 units of work each (J = 1: two steps a call).
    Call 1: prepare [1, 2], launch [2, 3] with three launch calls, B3's
    kernels [3, 5] and [5, 8], stopper [8, 9]; call 2: a launch span with
    three launch calls and B3's kernels [21, 28]. A launch call outside every
    span and a kernel of another name are not counted."""
    calls = [Call(0, 10 * US, 2.0), Call(20 * US, 30 * US, 2.0)]
    forward = "void (anonymous namespace)::forward_kernel<2>(float const*)"
    update = "void (anonymous namespace)::update_kernel<2>(float const*)"
    stop = "(anonymous namespace)::stop_kernel(double const*)"
    device = [Op(name, a * US, b * US, "kernel") for name, a, b in (
        (forward, 3, 5), (update, 5, 8), (stop, 21, 22), (forward, 22, 28),
        ("fused_forward_kernel", 28, 29))]
    host = [Op("cudaLaunchKernel", t * US, t * US + 100) for t in (2, 2.3, 2.6, 20.2, 20.4, 20.6)]
    host.append(Op("cudaLaunchKernel", 15 * US, 15 * US + 100))
    if spans:
        host += [Op("pls.general_train.prepare", 1 * US, 2 * US),
                 Op("pls.general_train.launch", 2 * US, 3 * US),
                 Op("pls.general_train.stopper", 8 * US, 9 * US),
                 Op("pls.general_train.launch", 20 * US, 21 * US)]
    return Trace(device, host, calls)


def test_the_cells_metrics_on_a_recorded_trace():
    trace = recorded()
    shapes = {"n": 1000, "m_k": 50, "j": 1, "general_train_steps": 4}
    busy = 5e-6 + 8e-6  # [3, 8] and [21, 29]
    assert reader("updates_mfu.general").read(trace, shapes) == pytest.approx(
        100 * 4 * 1000 * 50 * 4.0 / (busy * 495e12))
    # B3's kernels 12 us over four steps; the other kernel is not B3's
    least = max(4.0 * 1000 * 50 / 495e12, 4.0 * (1000 * 50 + 2 * 50 + 2 * 1000) / 3.35e12)
    assert reader("b3_roofline.general").read(trace, shapes) == pytest.approx(
        100 * least / 3e-6)
    assert reader("kernels_per_step.general").read(trace, shapes) == pytest.approx(6 / 4)
    # idle under prepare [1, 2] and stopper [8, 9] of call 1: 1 + 1 us over two calls
    assert reader("general_host_ms").read(trace, shapes) == pytest.approx(1e-3)
    assert reader("idle_pct.general").read(trace, shapes) == pytest.approx(
        100 * (1 - busy / 30e-6))


def test_a_program_without_the_spans_or_counter_reads_nothing_there():
    trace = recorded(spans=False)
    shapes = {"n": 1000, "m_k": 50, "j": 1, "general_train_steps": None}
    for name in ("kernels_per_step.general", "general_host_ms"):
        assert reader(name).read(trace, shapes) is None
    empty = Trace([], [], [Call(0, 10 * US, 1.0)])
    for name in ("updates_mfu.general", "b3_roofline.general"):
        assert reader(name).read(empty, shapes) is None


def tiny_cell(dtype: str = "float64"):
    """The cell at a tiny size on the CPU: 64 rows, 16 inducing points at a
    lengthscale that keeps all 16 eigenpairs, J = 8, 20 steps."""
    config = copy.deepcopy(SPEC.config)
    config.update(rows=64, inducing_points=16, dtype=dtype)
    config["kernel"]["lengthscale"] = 0.3
    config["pls"]["number_of_particles"] = 8
    traffic = {**SPEC.traffic, "steps": 20, "pool": 2}
    return SPEC.entry().Cell(config, traffic, 2**31 + 9, torch.device("cpu"))


def program(cell, i: int, cost=None) -> dict:
    """The port's ``general_fused`` tier (preconditioned) on the CPU, fed the
    mirror's normals of call ``i``."""
    from projected_langevin_sampling_torch.training import _train_pls_loop

    u0 = cell._start(i)["particles"]
    noise = pls_philox.normals(cell.philox_seed(i), cell.m_k, cell.j, 0, cell.steps, "cpu")
    run = _train_pls_loop(cell.pls.basis, cost or cell.pls.cost, u0, cell.eta, math.inf,
                          cell.steps, "general_fused", noise=noise.to(u0.dtype),
                          discretisation="preconditioned")
    return {"particles": run.particles, "energies": run.energies[run.recorded].tolist()}


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


@pytest.fixture(scope="module")
def truth(cell):
    return cell.reference(0)


def test_reference_matches_the_port_on_the_mirrors_normals(cell, truth):
    assert cell.m_k == 16 and len(truth["energies"]) == cell.steps
    readings = cell.compare(0, program(cell, 0), truth)
    # fp64 throughout; the port's MAP stops at a gradient under 1e-6, the
    # reference's under 1e-11
    assert readings["particles_gap"] < 1e-9 and readings["step_energy_gap"] < 1e-9, readings


def test_tf32_control_is_not_correct(cell, truth):
    readings = cell.compare(0, cell.reference(0, torch.float32), truth)
    assert any(readings[k] > limit for k, limit in SPEC.limits.items()), readings


def test_dropped_smoothing_is_not_correct(cell, truth):
    unsmoothed = cell.pls.cost.replace(smoothing_std=torch.zeros_like(cell.pls.cost.smoothing_std))
    readings = cell.compare(0, program(cell, 0, unsmoothed), truth)
    assert any(readings[k] > limit for k, limit in SPEC.limits.items()), readings


def _stuck(monkeypatch):
    """Every step of the kernel leaves the particles where they are (a zero
    step size: no drift, no decay, no noise)."""
    import projected_langevin_sampling_torch.training as training

    general_train = training.general_train
    monkeypatch.setattr(training, "general_train",
                        lambda *a, **k: general_train(*a, **{**k, "eta": 0.0}))


def _half_batch(monkeypatch):
    """The kernel handed the first half of the rows of P, y and the
    smoothing."""
    import projected_langevin_sampling_torch.training as training

    general_train = training.general_train

    def half(p, u0, y, lam, kind, aux=None, **kwargs):
        h = p.shape[0] // 2
        return general_train(p[:h], u0, y[:h], lam, kind,
                             aux=None if aux is None else aux[:h], **kwargs)

    monkeypatch.setattr(training, "general_train", half)


@pytest.mark.parametrize("fault", [_stuck, _half_batch])
def test_a_broken_timed_path_is_not_correct(cell, truth, monkeypatch, fault):
    fault(monkeypatch)
    readings = cell.compare(0, program(cell, 0), truth)
    assert any(readings[k] > limit for k, limit in SPEC.limits.items()), readings


def test_one_altered_number_is_not_correct(cell, truth):
    """One element of the returned particles moved by 1e-4."""
    answer = program(cell, 0)
    answer["particles"] = answer["particles"].clone()
    answer["particles"][0, 0] += 1e-4
    readings = cell.compare(0, answer, truth)
    assert readings["particles_gap"] > SPEC.limits["particles_gap"], readings


def test_the_float32_cell_keeps_the_float64_build():
    """The model is built in fp64 and rounded: its fp32 projection is the
    reference's, rounded."""
    cell = tiny_cell("float32")
    p = cell.pls.basis.train_projection
    assert p.dtype == torch.float32 and cell.pls.cost.smoothing_std.dtype == torch.float32
    gap = float(torch.max(torch.abs(p.double() - cell.model().projection)))
    assert gap <= 1e-6 * float(torch.max(torch.abs(cell.model().projection)))


@pytest.mark.card
def test_b3_draws_the_mirrors_normals(card):
    """With P = 0 the update is U' = U - (1 - dec) U + nscale eps: two steps of B3 give
    back its normals, which are the mirror's to fp32 rounding."""
    from projected_langevin_sampling_torch.ops.cuda.general_train import (
        general_train,
        split_row_constants,
    )

    m, j, n, eta, seed = 70, 10, 32, 1e-3, 2**61 + 77
    lam = torch.linspace(0.5, 2.0, m, dtype=torch.float32, device=card)
    u0 = torch.zeros((m, j), dtype=torch.float32, device=card)
    p = torch.zeros((n, m), dtype=torch.float32, device=card)
    y = torch.zeros(n, dtype=torch.float32, device=card)
    _, one_minus_dec, _, nscale = (
        c[:, None] for c in split_row_constants(lam, eta, "preconditioned"))
    mirror = pls_philox.normals(seed, m, j, 0, 2, card)
    u1 = general_train(p, u0, y, lam, "gaussian", eta=eta, patience=math.inf, num_steps=1,
                       params=(1.0, 0.0, 0.0), discretisation="preconditioned", seed=seed)[0]
    u2 = general_train(p, u0, y, lam, "gaussian", eta=eta, patience=math.inf, num_steps=2,
                       params=(1.0, 0.0, 0.0), discretisation="preconditioned", seed=seed)[0]
    drawn = torch.stack([u1 / nscale, (u2 - u1 + one_minus_dec * u1) / nscale]).double()
    assert float(torch.max(torch.abs(drawn - mirror))) < 2e-5


@pytest.mark.card
def test_a_short_traced_run_reads_every_metric(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                          str(2**31 + 11), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200, check=False)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == set(METRICS), result
    values = {k: v["value"] for k, v in result["metrics"].items()}
    for share in ("updates_mfu.general", "b3_roofline.general"):
        assert 0.0 < values[share] <= 100.0, values
    # three launches a step and two a run
    assert 3.0 <= values["kernels_per_step.general"] <= 3.01, values
