"""The program's spans (``utils/tracing.span``) in ``train_pls`` (the ``off``
tier), ``fit_svgp`` and ``fit_exact_gp``, and in the wrappers of the
general-cost and quadratic-tier kernels.

With no profiler running nothing is constructed. Under
``torch.profiler.profile`` a call opens its outer span and one
``pls.run_training``, one ``.chunk`` and one ``.sync`` a chunk (as many as
``RunStats.host_syncs``), and a read-back span; every span lies inside its
parent, and the answers are bit for bit those of a run with the profiler
off. On the card a graphed run also opens one ``.warmup`` and one
``.capture`` a graph it captures (``RunStats.captures``), and no span
appears on the device's timeline.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch.utils import early_stopper

CHUNK, STEPS = 3, 10  # four chunks, the last one short


def _kernel(d, device="cpu"):
    return pt.ARDKernel(torch.full((d,), 0.8, dtype=torch.float64, device=device),
                        torch.tensor(1.2, dtype=torch.float64, device=device))


def _gp_data(n=24, d=2, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    y = np.sin(x.sum(1)) + 0.1 * rng.normal(size=n)
    return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)


def _train_pls():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.sort(rng.uniform(-2.0, 2.0, (40, 1)), 0))
    y = torch.sin(2.0 * x[:, 0]) + 0.1 * torch.as_tensor(rng.normal(size=40))
    z = x[::5][:8]
    kernel = pt.PLSKernel(base_kernel=pt.ARDKernel(torch.tensor([0.6], dtype=torch.float64),
                                                   torch.tensor(1.0, dtype=torch.float64)),
                          approximation_samples=z)
    basis = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    pls = pt.PLS(basis, pt.StudentTCost(y_train=y, degrees_of_freedom=4.0, scale=0.3))
    u0 = pls.initialise_particles(6, generator=0)
    particles, energies = pt.train_pls(pls, u0, STEPS, 1e-3, generator=3, fast_path="off")
    return [particles, torch.tensor(energies)]


def _fit_svgp():
    x, y = _gp_data()
    z = torch.as_tensor(np.random.default_rng(1).uniform(-2.0, 2.0, (6, 2)))
    svgp = pt.init_svgp(0.1, _kernel(2), pt.GaussianLikelihood(
        noise=torch.tensor(0.2, dtype=torch.float64)), z)
    fit, losses = pt.fit_svgp(svgp, x, y, STEPS, 8, 0.05, generator=5)
    return [fit.mean_constant, fit.variational_mean, fit.variational_chol, fit.likelihood.noise,
            torch.tensor(losses)]


def _fit_exact_gp(device="cpu"):
    x, y = _gp_data(device=device)
    gp, losses = pt.fit_exact_gp(x, y, _kernel(2, device), noise=0.1, learning_rate=0.05,
                                 number_of_epochs=STEPS)
    return [gp.mean_constant, gp.kernel.lengthscales, gp.kernel.outputscale, gp.noise,
            torch.tensor(losses)]


GENERAL_SPANS = ("pls.general_train.prepare", "pls.general_train.launch",
                 "pls.general_train.stopper")


def _general_fused(device="cpu"):
    """A smoothed-Bernoulli ONB model trained on the ``general_fused`` tier
    (preconditioned): the general-cost kernel on the card, its plain loop on
    the CPU."""
    dtype = torch.float64 if device == "cpu" else torch.float32
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    x = as_t(np.sort(rng.uniform(-2.0, 2.0, (40, 1)), 0))
    y = (torch.sin(2.0 * x[:, 0]) + 0.2 * as_t(rng.normal(size=40)) > 0).to(dtype)
    z = x[::5][:8]
    kernel = pt.PLSKernel(base_kernel=pt.ARDKernel(as_t([0.6]), as_t(1.0)),
                          approximation_samples=z)
    basis = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    pls = pt.PLS(basis, pt.make_smoothed_bernoulli_cost(y, torch.full_like(y, 0.3)))
    u0 = pls.initialise_particles(6, generator=0)
    return pt.train_pls(pls, u0, STEPS, 1e-3, generator=3, fast_path="general_fused",
                        discretisation="preconditioned")


QUADRATIC_SPANS = ("pls.quadratic_train.prepare", "pls.quadratic_train.launch",
                   "pls.quadratic_train.stopper")


def _quadratic_fused(device="cpu"):
    """A Gaussian-cost IPB model trained on the ``quadratic_fused`` tier: B4
    on the card, its plain loop on the CPU."""
    dtype = torch.float64 if device == "cpu" else torch.float32
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    x = as_t(np.sort(rng.uniform(-2.0, 2.0, (40, 1)), 0))
    y = torch.sin(2.0 * x[:, 0]) + 0.1 * as_t(rng.normal(size=40))
    z = x[::5][:8]
    kernel = pt.PLSKernel(base_kernel=pt.ARDKernel(as_t([0.6]), as_t(1.0)),
                          approximation_samples=x)
    basis = pt.build_inducing_point_basis(kernel, z, torch.sin(2.0 * z[:, 0]), x)
    pls = pt.PLS(basis, pt.GaussianCost(y_train=y, observation_noise=as_t(0.1)))
    u0 = pls.initialise_particles(6, noise_only=False, generator=0)
    return pt.train_pls(pls, u0, STEPS, 1e-3, generator=3, fast_path="quadratic_fused")


# call, its outer span, its read-back span
CALLS = {
    "train_pls": (_train_pls, "pls.train_pls", "pls.train_pls.readback"),
    "fit_svgp": (_fit_svgp, "pls.fit_svgp", "pls.fit.readback"),
    "fit_exact_gp": (_fit_exact_gp, "pls.fit_exact_gp", "pls.fit.readback"),
}


@pytest.fixture(params=list(CALLS))
def call(request, monkeypatch):
    monkeypatch.setattr(early_stopper, "CHECK_EVERY", CHUNK)
    return CALLS[request.param]


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) of the ``pls.`` spans on the host, by start."""
    spans = [(e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("pls.") and "cpu" in str(e.device_type()).lower()]
    return sorted(spans, key=lambda s: s[1])


def _bits(values):
    return [v.detach().contiguous().view(torch.int64) for v in values]


def test_no_record_function_with_the_profiler_off(call, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"a record function ({name}) with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    call[0]()


def test_spans_per_call_and_chunk(call):
    fn, outer, readback = call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    stats = early_stopper.last_run_stats
    names = [s[0] for s in _spans(prof)]
    chunks = math.ceil(STEPS / CHUNK)
    assert stats.host_syncs == chunks and stats.captures == 0
    assert names.count(outer) == names.count("pls.run_training") == names.count(readback) == 1
    assert names.count("pls.run_training.chunk") == chunks
    assert names.count("pls.run_training.sync") == stats.host_syncs
    assert set(names) == {outer, readback, "pls.run_training", "pls.run_training.chunk",
                          "pls.run_training.sync"}


def test_every_span_lies_inside_its_parent(call):
    fn, outer, readback = call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = _spans(prof)
    where = {name: (a, b) for name, a, b in spans if name in (outer, "pls.run_training")}
    for name, a, b in spans:
        if name == outer:
            continue
        parent = "pls.run_training" if name.startswith("pls.run_training.") else outer
        assert where[parent][0] <= a <= b <= where[parent][1], name
    # the run's chunks and flag reads alternate, a chunk before its read
    inner = [name for name, _, _ in spans if name.startswith("pls.run_training.")]
    assert inner == ["pls.run_training.chunk", "pls.run_training.sync"] * math.ceil(STEPS / CHUNK)


def test_answers_do_not_depend_on_the_profiler(call):
    fn = call[0]
    off = fn()
    with profile(activities=[ProfilerActivity.CPU]):
        on = fn()
    assert all(torch.equal(a, b) for a, b in zip(_bits(off), _bits(on)))


def test_a_frozen_svgp_fit_opens_one_projection_span(monkeypatch):
    """A fit that learns neither its kernel nor its inducing inputs projects
    the data once, in ``pls.fit_svgp.project`` inside its outer span and
    before its run; a fit that learns its kernel opens no such span."""
    monkeypatch.setattr(early_stopper, "CHECK_EVERY", CHUNK)
    x, y = _gp_data()
    z = torch.as_tensor(np.random.default_rng(1).uniform(-2.0, 2.0, (6, 2)))
    svgp = pt.init_svgp(0.1, pt.PLSKernel(base_kernel=_kernel(2), approximation_samples=z),
                        pt.GaussianLikelihood(noise=torch.tensor(0.2, dtype=torch.float64)), z)
    for learn_kernel, opened in ((False, 1), (True, 0)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pt.fit_svgp(svgp, x, y, STEPS, 8, 0.05, learn_kernel_parameters=learn_kernel,
                        generator=5)
        spans = _spans(prof)
        where = {name: (a, b) for name, a, b in spans}
        assert [s[0] for s in spans].count("pls.fit_svgp.project") == opened
        if opened:
            a, b = where["pls.fit_svgp.project"]
            assert where["pls.fit_svgp"][0] <= a <= b <= where["pls.run_training"][0]


@pytest.mark.card
def test_a_graphed_run_opens_a_warmup_and_a_capture_a_graph(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest tests/test_torch_tracing.py "
                    "-m card --noconftest)")
    monkeypatch.setattr(early_stopper, "CHECK_EVERY", CHUNK)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fit_exact_gp(device="cuda")
    stats = early_stopper.last_run_stats
    names = [s[0] for s in _spans(prof)]
    assert stats.mode == "graph" and stats.captures >= 1
    assert names.count("pls.run_training.warmup") == stats.captures
    assert names.count("pls.run_training.capture") == stats.captures
    assert names.count("pls.run_training.close") == stats.captures
    assert names.count("pls.run_training.sync") == stats.host_syncs == math.ceil(STEPS / CHUNK)
    # no span is mirrored onto the device's timeline, where it would read as work
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("pls.") and "cuda" in str(e.device_type()).lower()]


def test_general_fused_on_the_cpu_opens_the_wrappers_span_only():
    """On CPU tensors the wrapper runs its plain loop inside ``pls.general_train``:
    no kernel is prepared, launched or counted."""
    from projected_langevin_sampling_torch.ops.cuda.general_train import general_train

    before = general_train.launches, general_train.steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _general_fused()
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("pls.train_pls") == names.count("pls.general_train") == 1
    assert not set(GENERAL_SPANS) & set(names)
    outer = next(s for s in spans if s[0] == "pls.train_pls")
    inner = next(s for s in spans if s[0] == "pls.general_train")
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]
    assert (general_train.launches, general_train.steps) == before


@pytest.mark.card
def test_a_general_fused_run_opens_one_launch_and_counts_its_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest tests/test_torch_tracing.py "
                    "-m card --noconftest)")
    from projected_langevin_sampling_torch.ops.cuda.general_train import general_train

    _general_fused(device="cuda")  # builds the kernel outside the trace
    before = general_train.launches, general_train.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, energies = _general_fused(device="cuda")
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert [names.count(n) for n in ("pls.general_train", *GENERAL_SPANS)] == [1, 1, 1, 1]
    where = {name: (a, b) for name, a, b in spans}
    outer = where["pls.general_train"]
    assert where["pls.train_pls"][0] <= outer[0] <= outer[1] <= where["pls.train_pls"][1]
    stages = [where[n] for n in GENERAL_SPANS]
    assert all(outer[0] <= a <= b <= outer[1] for a, b in stages)
    assert stages[0][1] <= stages[1][0] and stages[1][1] <= stages[2][0]
    assert general_train.launches == before[0] + 1
    assert general_train.steps == before[1] + STEPS == before[1] + len(energies)


def test_quadratic_fused_on_the_cpu_opens_the_wrappers_span_and_counts_its_steps():
    """On CPU tensors ``train_pls`` makes the M-space system inside
    ``pls.train_pls.quadratic_system`` and B4's wrapper runs its plain loop
    inside ``pls.quadratic_train``: no kernel is prepared or launched, and the
    steps are counted."""
    from projected_langevin_sampling_torch.ops.cuda.quadratic_train import quadratic_train

    before = quadratic_train.launches, quadratic_train.steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _quadratic_fused()
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert [names.count(n) for n in ("pls.train_pls", "pls.train_pls.quadratic_system",
                                     "pls.quadratic_train")] == [1, 1, 1]
    assert not set(QUADRATIC_SPANS) & set(names)
    where = {name: (a, b) for name, a, b in spans}
    outer, system, inner = (where[n] for n in ("pls.train_pls", "pls.train_pls.quadratic_system",
                                               "pls.quadratic_train"))
    assert outer[0] <= system[0] <= system[1] <= inner[0] <= inner[1] <= outer[1]
    assert (quadratic_train.launches, quadratic_train.steps) == (before[0], before[1] + STEPS)


@pytest.mark.card
def test_a_quadratic_fused_run_opens_one_span_of_each_stage_and_counts_its_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest tests/test_torch_tracing.py "
                    "-m card --noconftest)")
    from projected_langevin_sampling_torch.ops.cuda.quadratic_train import quadratic_train

    _quadratic_fused(device="cuda")  # builds the kernel outside the trace
    before = quadratic_train.launches, quadratic_train.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, energies = _quadratic_fused(device="cuda")
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert [names.count(n) for n in ("pls.train_pls.quadratic_system", "pls.quadratic_train",
                                     *QUADRATIC_SPANS)] == [1, 1, 1, 1, 1]
    where = {name: (a, b) for name, a, b in spans}
    outer = where["pls.quadratic_train"]
    assert where["pls.train_pls"][0] <= outer[0] <= outer[1] <= where["pls.train_pls"][1]
    assert where["pls.train_pls.quadratic_system"][1] <= outer[0]
    stages = [where[n] for n in QUADRATIC_SPANS]
    assert all(outer[0] <= a <= b <= outer[1] for a, b in stages)
    assert stages[0][1] <= stages[1][0] and stages[1][1] <= stages[2][0]
    assert quadratic_train.launches == before[0] + 1
    assert quadratic_train.steps == before[1] + STEPS == before[1] + len(energies)
