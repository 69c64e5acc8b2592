"""The ``headline_ipb.train`` cell, whose kernel (B4) draws its Langevin
normals itself.

On the CPU: the mirror of B4's normals (stream 2 of the Philox counter,
B4's layout as its source states it, the seed ``train_pls`` draws), the
starting states rebuilt from their seeds, and the plain reference held
against the port's ``quadratic_fused`` tier fed the mirror's normals at a
tiny size: the sound run agrees at fp64 rounding; the TF32 control, a run
whose noise factor has one column flipped, a run without the prior's
M K^-1 drift, a stuck run and one altered number come out not correct. The
cell's per-layer metrics on a recorded trace, from the profiler and from
B4's own record, and on a program without the new spans and counter.
On the card: B4's own normals against the mirror, and a short traced run of
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
from benchmark.reference import pls_quadratic
from benchmark.run import HERE, ROOT, Spec, load_module
from benchmark.tests.test_bench_headline import SEEDS, scalar_philox

CELL = "headline_ipb.train"
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
SPEC = Spec(BENCH, CELL)
METRICS = [m["name"] for m in SPEC.per_layer]
F = 0xFFFFFFFF


def scalar_normal(seed: int, t: int, r: int, c: int) -> float:
    """The normal of update ``t`` at row ``r``, column ``c``, from B4's
    counter (c // 4, r, t, 2) and its Box-Muller pairs."""
    words = scalar_philox((c // 4, r, t, 2), (seed & F, seed >> 32))
    a, b = words[2 * ((c % 4) // 2):][:2]
    radius = math.sqrt(-2.0 * math.log(((a >> 8) + 1) * 2.0**-24))
    angle = 2.0 * math.pi * ((b >> 8) + 1) * 2.0**-24
    return radius * (math.cos(angle) if c % 2 == 0 else math.sin(angle))


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_follow_b4s_counters(seed):
    m, j, first, steps = 5, 10, 3, 4  # J not a multiple of 4: a partial group
    z = pls_quadratic.normals(seed, m, j, first, steps, "cpu")
    assert z.shape == (steps, m, j) and z.dtype == torch.float64
    for t in range(steps):
        for r in range(m):
            for c in range(j):
                assert float(z[t, r, c]) == pytest.approx(scalar_normal(seed, first + t, r, c),
                                                          rel=1e-12, abs=1e-12)


def test_the_mirror_copies_b4s_layout():
    """The counter the mirror copies, as B4's source states it."""
    with open(os.path.join(ROOT, "projected_langevin_sampling_torch", "csrc",
                           "quadratic_train.cu")) as f:
        kernel = " ".join(f.read().split())
    assert "constexpr uint32_t STREAM_ID = 2u;" in kernel and pls_quadratic.STREAM == 2
    assert ("plst::normals4( make_uint4((uint32_t)(cgroup + r.j0 / GROUP), (uint32_t)row, "
            "(uint32_t)step, STREAM_ID), r.key, z);" in kernel)
    assert "if (!r.zero_noise) draw_normals(r, 0);" in kernel  # update t draws step t


def tiny_cell(dtype: str = "float64"):
    """The cell at a tiny size on the CPU: 200 rows, 32 inducing points at a
    lengthscale of 0.1, J = 9, 50 steps."""
    config = copy.deepcopy(SPEC.config)
    config.update(rows=200, inducing_points=32, dtype=dtype)
    config["kernel"]["lengthscale"] = 0.1
    config["pls"]["number_of_particles"] = 9
    traffic = {**SPEC.traffic, "steps": 50, "pool": 2}
    return SPEC.entry().Cell(config, traffic, 2**31 + 9, torch.device("cpu"))


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


@pytest.fixture(scope="module")
def truth(cell):
    return cell.reference(0)


def test_the_kernels_seed_is_the_calls_first_draw(cell, monkeypatch):
    """``philox_seed`` is the seed ``train_pls`` hands B4's wrapper."""
    import projected_langevin_sampling_torch.training as training

    seen = []
    quadratic_train = training.quadratic_train

    def spy(*args, **kwargs):
        seen.append(kwargs["seed"])
        return quadratic_train(*args, **kwargs)

    monkeypatch.setattr(training, "quadratic_train", spy)
    cell.call(0)
    assert seen == [cell.philox_seed(0)]


def test_the_reference_rebuilds_the_starts(cell, truth):
    """The pool's particles are the README's ``initialise_particles``, which
    the reference rebuilds from the start's seed."""
    assert float(torch.max(torch.abs(cell._start(0)["particles"] - truth["start"]))) < 1e-12


def program(cell, i: int, monkeypatch, fault=lambda args: args) -> dict:
    """Call ``i`` of the cell with B4's wrapper fed the mirror's normals;
    ``fault`` rewrites the positional arguments (A, b, E, e_bias, S, U0)
    ``train_pls`` hands it."""
    import projected_langevin_sampling_torch.training as training

    noise = pls_quadratic.normals(cell.philox_seed(i), cell.m, cell.j, 0, cell.steps, "cpu")
    quadratic_train = training.quadratic_train
    monkeypatch.setattr(training, "quadratic_train", lambda *args, **kwargs: quadratic_train(
        *fault(args), **{**kwargs, "noise": noise}))
    cell.call(i)
    monkeypatch.undo()
    return cell.answers[i]


def not_correct(readings: dict) -> bool:
    return any(readings[k] > limit for k, limit in SPEC.limits.items())


def test_reference_matches_the_port_on_the_mirrors_normals(cell, truth, monkeypatch):
    assert cell.m == 32 and len(truth["energies"]) == cell.steps
    readings = cell.compare(0, program(cell, 0, monkeypatch), truth)
    assert readings["particles_gap"] < 1e-10 and readings["step_energy_gap"] < 1e-10, readings


def test_tf32_control_is_not_correct(cell, truth):
    readings = cell.compare(0, cell.reference(0, torch.float32), truth)
    assert not_correct(readings), readings


def _flipped_column(cell):
    def fault(args):
        a, b, e, e_bias, s, u0 = args
        s = s.clone()
        s[:, cell.m // 2] = -s[:, cell.m // 2]
        return a, b, e, e_bias, s, u0

    return fault


def _dropped_prior(cell):
    prior = cell.m * cell.pls.basis.inv_base_gram_induce
    return lambda args: (args[0] - prior, *args[1:])


def _stuck(cell):
    """Every step leaves the particles where they are: no drift, no noise."""
    def fault(args):
        a, b, e, e_bias, s, u0 = args
        return torch.zeros_like(a), torch.zeros_like(b), e, e_bias, torch.zeros_like(s), u0

    return fault


@pytest.mark.parametrize("fault", [_flipped_column, _dropped_prior, _stuck])
def test_a_broken_timed_path_is_not_correct(cell, truth, monkeypatch, fault):
    readings = cell.compare(0, program(cell, 0, monkeypatch, fault(cell)), truth)
    assert not_correct(readings), readings


def test_one_altered_number_is_not_correct(cell, truth, monkeypatch):
    """One element of the returned particles moved by 1e-4."""
    answer = dict(program(cell, 0, monkeypatch))
    answer["particles"] = answer["particles"].clone()
    answer["particles"][0, 0] += 1e-4
    readings = cell.compare(0, answer, truth)
    assert readings["particles_gap"] > SPEC.limits["particles_gap"], readings


def test_the_float32_cell_keeps_the_float64_build():
    """The model is built in fp64 and rounded: its fp32 projection and noise
    factor are the reference's, rounded."""
    cell = tiny_cell("float32")
    basis = cell.pls.basis
    assert basis.train_projection.dtype == cell.pls.cost.y_train.dtype == torch.float32
    for mine, theirs in ((basis.train_projection, cell.model().projection),
                         (basis.noise_factor, cell.model().noise_factor)):
        gap = float(torch.max(torch.abs(mine.double() - theirs)))
        assert gap <= 1e-6 * float(torch.max(torch.abs(theirs)))


US = 1000  # ns
B4 = "(anonymous namespace)::quadratic_run_kernel((anonymous namespace)::Run)"


def reader(name):
    return load_module(f"{HERE}/metrics/{name}.py", f"metric_{name.replace('.', '_')}")


def recorded(spans: bool = True, b4_in_call_2: bool = True) -> Trace:
    """Two calls of 10 us, 2 units of work each (J = 1: two steps a call).
    Call 1: the system [1, 2] with a product [1.5, 1.8] in it, prepare [2,
    3], launch [3, 3.2], B4 [3.5, 8], stopper [8.5, 9]; call 2: B4 [22, 28],
    which the profiler may miss. A kernel of another name after the calls
    is not counted."""
    calls = [Call(0, 10 * US, 2.0), Call(20 * US, 30 * US, 2.0)]
    device = [Op("sgemm", 1.5 * US, 1.8 * US, "kernel"), Op(B4, 3.5 * US, 8 * US, "kernel"),
              Op("forward_kernel", 31 * US, 32 * US, "kernel")]
    if b4_in_call_2:
        device.append(Op(B4, 22 * US, 28 * US, "kernel"))
    host = []
    if spans:
        host += [Op("pls.train_pls.quadratic_system", 1 * US, 2 * US),
                 Op("pls.quadratic_train.prepare", 2 * US, 3 * US),
                 Op("pls.quadratic_train.launch", 3 * US, 3.2 * US),
                 Op("pls.quadratic_train.stopper", 8.5 * US, 9 * US)]
    return Trace(device, host, calls)


SHAPES = {"n": 1000, "m_k": 50, "j": 1, "quadratic_train_steps": 4, "b4_ms": [4.5e-3, 6e-3]}


@pytest.mark.parametrize("b4_in_call_2", [True, False])
def test_the_cells_metrics_on_a_recorded_trace(b4_in_call_2):
    """The same readings whether the profiler recorded B4 in every call or
    B4's own record stands in for it."""
    trace = recorded(b4_in_call_2=b4_in_call_2)
    busy = 0.3e-6 + 4.5e-6 + 6e-6
    assert reader("updates_mfu.ipb").read(trace, SHAPES) == pytest.approx(
        100 * 6 * 50**2 * 4.0 / (busy * 495e12))
    # B4 10.5 us over four steps; U read and written bound this tiny step
    least = max(6.0 * 50**2 / 495e12, 8.0 * 50 / 3.35e12)
    assert reader("b4_roofline.ipb").read(trace, SHAPES) == pytest.approx(
        100 * least / 2.625e-6)
    # idle under the system [1, 1.5] and [1.8, 2], prepare [2, 3] and
    # stopper [8.5, 9] of call 1: 2.2 us over two calls
    assert reader("quadratic_host_ms").read(trace, SHAPES) == pytest.approx(1.1e-3)


def test_a_program_without_the_spans_reads_no_host_ms():
    assert reader("quadratic_host_ms").read(recorded(spans=False), SHAPES) is None


def test_no_b4_time_reads_nothing():
    """Neither the profiler nor B4's record saw call 2."""
    trace = recorded(b4_in_call_2=False)
    shapes = {**SHAPES, "b4_ms": [4.5e-3]}
    for name in ("updates_mfu.ipb", "b4_roofline.ipb"):
        assert reader(name).read(trace, shapes) is None


@pytest.mark.card
def test_b4_draws_the_mirrors_normals(card):
    """With A = E = 0, S = I and eta = 1/2 an update is U' = U + eps: two
    runs of B4 from U0 = 0 give back its normals, which are the mirror's to
    fp32 rounding."""
    from projected_langevin_sampling_torch.ops.cuda.quadratic_train import quadratic_train

    m, j, seed = 70, 10, 2**61 + 77
    zeros = torch.zeros((m, m), dtype=torch.float32, device=card)
    vec = torch.zeros(m, dtype=torch.float32, device=card)
    eye = torch.eye(m, dtype=torch.float32, device=card)
    u0 = torch.zeros((m, j), dtype=torch.float32, device=card)
    runs = [quadratic_train(zeros, vec, zeros, vec, eye, u0, eta=0.5, patience=math.inf,
                            e_const=0.0, num_steps=steps, shared=False, seed=seed)[0]
            for steps in (1, 2)]
    drawn = torch.stack([runs[0], runs[1] - runs[0]]).double()
    mirror = pls_quadratic.normals(seed, m, j, 0, 2, card)
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
    for share in ("updates_mfu.ipb", "b4_roofline.ipb"):
        assert 0.0 < values[share] <= 100.0, values
