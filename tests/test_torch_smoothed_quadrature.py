"""The smoothed-Bernoulli quadrature kernel (``ops/cuda/smoothed_bernoulli.py``)
and the ``off`` tier's step, which takes a cost and its derivative of one F
in one call (``calculate_cost_and_derivative``).

On the CPU (no JAX here): the combined call is each cost's two methods bit
for bit, also where F and the rule differ in dtype; the wrapper's plain version is the node-by-node arithmetic the cost
has always had; the wrapper refuses what the kernel does not take; the
``off`` tier is the earlier step, which carried F and asked for the
derivative at the start of the next step, bit for bit, for every cost.

On the card (``-m card``): the kernel against its plain version at rice's
shape and at edge shapes, a rerun bitwise equal, the cost sending a CUDA F
of any dtype to the kernel, and a graphed ``off``-tier run counting a launch
a step and matching the eager plain run. Run them with

    python -m pytest tests/test_torch_smoothed_quadrature.py -m card --noconftest -q
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch import training
from projected_langevin_sampling_torch.models.basis.inducing_point import (
    build_inducing_point_basis,
)
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    GaussianCost,
    MultiModalCost,
    PLSCostMixin,
    PoissonCost,
    SmoothedBernoulliCost,
    StudentTCost,
    make_smoothed_bernoulli_cost,
    residual_smoothing_std,
)
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.cuda import smoothed_bernoulli as sb
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_torch.utils import early_stopper
from projected_langevin_sampling_torch.utils.columns import column_mean

N, M, J, STEPS, ETA = 40, 10, 6, 30, 1e-3
COSTS = ("gaussian", "bernoulli", "poisson", "student_t", "multimodal", "smoothed")


def _data(n=N, device="cpu", dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 2), generator=g, dtype=torch.float64) * 4 - 2
    latent = torch.sin(2 * x[:, 0]) + 0.5 * x[:, 1]
    noisy = latent + 0.3 * torch.randn(n, generator=g, dtype=torch.float64)
    as_ = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return as_(x), as_(noisy), as_((noisy > 0).to(torch.float64)), as_(torch.round(latent**2 * 3))


def _model(name, basis_kind="onb", n=N, m=M, device="cpu", dtype=torch.float64):
    x, y_real, y_bin, y_count = _data(n, device, dtype)
    opts = dict(dtype=dtype, device=device)
    ard = ARDKernel(torch.tensor([0.8, 1.2], **opts), torch.tensor(1.0, **opts))
    z = x[:m]
    if basis_kind == "onb":
        basis = build_orthonormal_basis(PLSKernel(ard, z), z, x, scaling="nystrom",
                                        relative_eigenvalue_threshold=1e-6, verbose=False)
        s = residual_smoothing_std(basis, ard(x, diag=True))
    else:
        basis = build_inducing_point_basis(PLSKernel(ard, z), z, y_real[:m], x)
        s = torch.linspace(0.0, 0.8, n, **opts)  # a row with s = 0 first
    cost = {
        "gaussian": lambda: GaussianCost(y_train=y_real, observation_noise=torch.tensor(0.1, **opts)),
        "bernoulli": lambda: BernoulliCost(y_train=y_bin),
        "poisson": lambda: PoissonCost(y_train=y_count),
        "student_t": lambda: StudentTCost(y_train=y_real, degrees_of_freedom=3.0, scale=0.5),
        "multimodal": lambda: MultiModalCost(y_train=y_real, observation_noise=torch.tensor(0.3, **opts),
                                             shift=1.0, bernoulli_noise=0.3),
        "smoothed": lambda: make_smoothed_bernoulli_cost(y_bin, s, device=device),
    }[name]()
    return basis, cost


def _f(n=N, j=J, scale=2.0, dtype=torch.float64, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn((n, j), generator=g, dtype=torch.float64)).to(dtype)


# --- the parent's arithmetic, as it stood before the combined call ------------
def _parent_softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _parent_expected(f, s, nodes, weights, fn):
    scale = math.sqrt(2.0) * s[:, None]
    acc = torch.zeros_like(f)
    for q in range(nodes.shape[0]):
        acc = acc + weights[q] * fn(f + scale * nodes[q])
    return acc / math.sqrt(math.pi)


def _parent_off_tier(basis, cost, particles, patience, generator, discretisation):
    """The ``off`` tier's run as it was: the step carried F and took the
    derivative of the previous step's F at its start."""
    draw = training._update_noise(basis, None, generator, particles.shape[1])
    if discretisation == "euler":
        def update(u, dc, t):
            return u + basis._calculate_particle_update(u, dc, ETA, draw(t))
    else:
        update = training._split_update(basis, ETA, discretisation, draw)

    def step(t, state):
        u, pred = state
        u_new = update(u, cost.calculate_cost_derivative(pred), t)
        pred_new = basis.calculate_untransformed_train_prediction_samples(u_new)
        energy_j = basis.calculate_particle_energies(u_new, cost.calculate_cost(pred_new))
        return (u_new, pred_new), column_mean(energy_j, None)

    state0 = (particles, basis.calculate_untransformed_train_prediction_samples(particles))
    run = early_stopper.run_training(step, state0, STEPS, ETA, patience, particles.dtype,
                                     particles.device)
    return run.state[0], run.energies, run.recorded, run.steps_run


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.nan_to_num(a, nan=1234.5), torch.nan_to_num(b, nan=1234.5))


# --- CPU ---------------------------------------------------------------------
MIXED = {  # F's dtype, the rule's
    "fp64-F-fp32-rule": (torch.float64, torch.float32),
    "fp32-F-fp64-rule": (torch.float32, torch.float64),
    "fp16-F-fp32-rule": (torch.float16, torch.float32),
}


@pytest.mark.parametrize("name,f_dtype,rule_dtype",
                         [(n, torch.float64, torch.float64) for n in COSTS]
                         + [("smoothed", *dtypes) for dtypes in MIXED.values()],
                         ids=list(COSTS) + [f"smoothed-{case}" for case in MIXED])
def test_cost_and_derivative_is_the_two_methods(name, f_dtype, rule_dtype):
    _, cost = _model(name, dtype=rule_dtype)
    f = _f(dtype=f_dtype)
    got_cost, got_dc = cost.calculate_cost_and_derivative(f)
    assert _bits_equal(got_cost, cost.calculate_cost(f))
    assert _bits_equal(got_dc, cost.calculate_cost_derivative(f))


def test_every_cost_of_the_package_is_covered():
    import projected_langevin_sampling_torch.models.costs as costs

    classes = {v for v in vars(costs).values()
               if isinstance(v, type) and issubclass(v, PLSCostMixin) and v is not PLSCostMixin}
    assert {type(_model(name)[1]) for name in COSTS} == classes


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["fp64", "fp32"])
@pytest.mark.parametrize("q", [16, 5])
def test_plain_version_is_the_parent_arithmetic(dtype, q):
    _, y, y_bin, _ = _data(dtype=dtype)
    s = torch.linspace(0.0, 1.5, N, dtype=dtype)
    cost = make_smoothed_bernoulli_cost(y_bin, s, number_of_quadrature_nodes=q)
    f = _f(dtype=dtype, scale=6.0)
    args = (cost.smoothing_std, cost.gh_nodes, cost.gh_weights)
    want_cost = torch.sum(_parent_expected(f, *args, _parent_softplus) - y_bin[:, None] * f, dim=0)
    want_dc = _parent_expected(f, *args, torch.sigmoid) - y_bin[:, None]
    for got_cost, got_dc in (sb.smoothed_bernoulli_reference(f, y_bin, *args),
                             (cost.calculate_cost(f), cost.calculate_cost_derivative(f))):
        assert _bits_equal(got_cost, want_cost) and _bits_equal(got_dc, want_dc)


def _kernel_log_constants():
    """LOG_POLY, LN2_HI and LN2_LO as ``csrc/smoothed_bernoulli.cu`` states them."""
    with open(os.path.join(sb.build.CSRC_DIR, "smoothed_bernoulli.cu")) as fh:
        text = fh.read()
    poly = re.search(r"LOG_POLY\[7\] = \{([^}]*)\}", text).group(1)
    ln2 = [float(re.search(rf"{name} = ([-+0-9.e]+);", text).group(1)) for name in ("LN2_HI", "LN2_LO")]
    return [float(v) for v in poly.split(",")], ln2


def _kernel_node_mirror(e):
    """The fp64 kernel's 1 / (1 + e) and log1p(e) (``add_node``) in numpy,
    its FMAs as two roundings."""
    poly, (ln2_hi, ln2_lo) = _kernel_log_constants()
    v = 1.0 + e
    k = np.where(v > 1.4142135623730951, 1.0, 0.0)
    c = 1.0 + k
    f, den = v - c, v + c
    d = 1.0 / (v * den)
    r, s = den * d, (f * v) * d
    z = s * s
    p = np.full_like(e, poly[6])
    for coefficient in poly[5::-1]:
        p = z * p + coefficient
    fm = np.where(k > 0, 0.5 * f, f)
    hfsq = 0.5 * fm * fm
    log_m = fm - (hfsq - s * (hfsq + z * p))
    log_v = k * ln2_hi + (log_m + k * ln2_lo)
    return r, (e - (v - 1.0)) * r + log_v


def test_the_kernels_fp64_log_and_reciprocal_are_within_a_few_ulp():
    rng = np.random.default_rng(0)
    e = np.concatenate([rng.uniform(0.0, 1.0, 200_000), np.exp(-rng.uniform(0.0, 700.0, 50_000)),
                        [0.0, 1.0, math.sqrt(2.0) - 1.0, 1e-300, 5e-324],
                        np.nextafter(math.sqrt(2.0) - 1.0, [0.0, 1.0])])
    r, log1p = _kernel_node_mirror(e)
    want = np.log1p(e)  # within 1 ulp
    rel = np.abs(log1p - want) / np.where(want > 0, want, 1.0)
    assert rel.max() <= 3 * 2.0**-52 and np.all(log1p[e == 0.0] == 0.0)
    want_r = 1.0 / (1.0 + e)
    assert (np.abs(r - want_r) / want_r).max() <= 2 * 2.0**-52


def _rule(n=N, q=16, dtype=torch.float64):
    cost = make_smoothed_bernoulli_cost(_data(n, dtype=dtype)[2], torch.full((n,), 0.5, dtype=dtype),
                                        number_of_quadrature_nodes=q)
    return [cost.y_train, cost.smoothing_std, cost.gh_nodes, cost.gh_weights]


REFUSED = {
    "float16 F": lambda: (_f().half(), [t.half() for t in _rule()]),
    "integer F": lambda: (_f().to(torch.int64), _rule()),
    "F of another dtype than the rule": lambda: (_f(dtype=torch.float32), _rule()),
    "non-contiguous F": lambda: (_f(J, N).T, _rule()),
    "F of one dimension": lambda: (_f()[:, 0], _rule()),
    "F with no columns": lambda: (_f()[:, :0], _rule()),
    "y of N - 1": lambda: (_f(), _rule(N - 1)[:1] + _rule()[1:]),
    "smoothing_std of N + 1": lambda: (_f(), _rule()[:1] + _rule(N + 1)[1:2] + _rule()[2:]),
    "weights of another length than the nodes": lambda: (_f(), _rule()[:3] + _rule(q=8)[3:]),
    "non-contiguous smoothing_std": lambda: (
        _f(), _rule()[:1] + [torch.full((2 * N,), 0.5, dtype=torch.float64)[::2]] + _rule()[2:]),
    "F that asks for a gradient": lambda: (_f().requires_grad_(), _rule()),
    "F on the CPU": lambda: (_f(), _rule()),
    "a rule too long for a block": lambda: (_f(), _rule()[:2] + [torch.zeros(3000, dtype=torch.float64)] * 2),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    f, rule = REFUSED[case]()
    before = sb.smoothed_bernoulli.launches
    with pytest.raises(ValueError, match="smoothed_bernoulli"):
        sb.smoothed_bernoulli(f, *rule)
    assert sb.smoothed_bernoulli.launches == before


def test_the_launch_counter_is_replayed_and_the_cpu_launches_nothing():
    assert (sb.smoothed_bernoulli, "launches") in early_stopper.REPLAYED_COUNTERS
    _, cost = _model("smoothed")
    before = sb.smoothed_bernoulli.launches
    cost.calculate_cost_and_derivative(_f())  # CPU: the plain path, nothing launched
    assert sb.smoothed_bernoulli.launches == before


@pytest.mark.parametrize("basis_kind,discretisation,patience", [
    ("onb", "euler", math.inf),
    ("onb", "preconditioned", math.inf),
    ("onb", "exponential", 0.004),
    ("ipb", "euler", math.inf),
], ids=["onb-euler", "onb-preconditioned", "onb-exponential-stops", "ipb-euler"])
@pytest.mark.parametrize("name", COSTS)
def test_off_tier_is_the_parent_bit_for_bit(name, basis_kind, discretisation, patience):
    basis, cost = _model(name, basis_kind)
    # near the prior's mode, where the noise soon raises the energy
    u0 = 0.01 * torch.randn((basis.approximation_dimension, J),
                            generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    got = training._train_pls_loop(basis, cost, u0, ETA, patience, STEPS, "off",
                                   generator=torch.Generator().manual_seed(5),
                                   discretisation=discretisation)
    want = _parent_off_tier(basis, cost, u0, patience, torch.Generator().manual_seed(5),
                            discretisation)
    assert _bits_equal(got.particles, want[0])
    assert _bits_equal(got.energies, want[1])
    assert torch.equal(got.recorded, want[2]) and int(got.steps_run) == int(want[3])
    if patience < math.inf and name == "smoothed":
        assert int(got.steps_run) < STEPS  # the stop and the frozen carry were exercised


def test_train_pls_off_tier_smoothed_is_the_parent():
    basis, cost = _model("smoothed")
    u0 = torch.randn((basis.approximation_dimension, J), generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    u, energies = training.train_pls(PLS(basis=basis, cost=cost), u0, STEPS, ETA,
                                     generator=torch.Generator().manual_seed(9), fast_path="off",
                                     discretisation="preconditioned")
    want = _parent_off_tier(basis, cost, u0, math.inf, torch.Generator().manual_seed(9),
                            "preconditioned")
    assert _bits_equal(u, want[0])
    assert energies == [float(e) for e in want[1].tolist()]


# --- the card ------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "tests/test_torch_smoothed_quadrature.py -m card --noconftest)")
    return torch.device("cuda")


def _card_inputs(n, j, dtype, f_scale=3.0, zero_std_rows=False, q=16, seed=11):
    g = torch.Generator().manual_seed(seed)
    f = f_scale * torch.randn((n, j), generator=g, dtype=torch.float64)
    y = (torch.rand(n, generator=g, dtype=torch.float64) > 0.5).to(torch.float64)
    s = 0.9 * torch.rand(n, generator=g, dtype=torch.float64)
    if zero_std_rows:
        s[::2] = 0.0
    cost = make_smoothed_bernoulli_cost(y.to(dtype), s.to(dtype), number_of_quadrature_nodes=q)
    return f.to(dtype), [cost.y_train, cost.smoothing_std, cost.gh_nodes, cost.gh_weights]


def _gaps(f, rule, device):
    want_cost, want_dc = sb.smoothed_bernoulli_reference(f.to(device), *[t.to(device) for t in rule])
    got_cost, got_dc = sb.smoothed_bernoulli(f.to(device), *[t.to(device) for t in rule])
    assert got_cost.dtype == f.dtype and got_dc.dtype == f.dtype
    dc_gap = float((got_dc - want_dc).abs().max() / want_dc.abs().max().clamp_min(1e-300))
    cost_gap = float((got_cost - want_cost).abs().max() / want_cost.abs().max().clamp_min(1e-300))
    return dc_gap, cost_gap


CARD_SHAPES = {  # (N, J, |F| scale, rows with s = 0, Q)
    "rice 3048 x 1000": (3048, 1000, 3.0, False, 16),
    "N = 1": (1, 300, 3.0, False, 16),
    "J = 1": (300, 1, 3.0, False, 16),
    "N = J = 1": (1, 1, 3.0, False, 16),
    "ragged 1037 x 129": (1037, 129, 3.0, False, 16),
    "rows with s = 0": (517, 257, 3.0, True, 16),
    "|F| up to 40": (640, 200, 13.0, False, 16),
    "|F| past exp's range": (300, 130, 400.0, False, 16),
    "a rule of 5 nodes": (300, 130, 3.0, False, 5),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_SHAPES))
def test_kernel_matches_plain_fp64(card, case):
    n, j, scale, zero_rows, q = CARD_SHAPES[case]
    f, rule = _card_inputs(n, j, torch.float64, scale, zero_rows, q)
    if case == "|F| up to 40":
        f = f.clamp(-40.0, 40.0)
        assert float(f.abs().max()) == 40.0
    dc_gap, cost_gap = _gaps(f, rule, card)
    assert dc_gap <= 1e-13 and cost_gap <= 1e-12, (dc_gap, cost_gap)


@pytest.mark.card
@pytest.mark.parametrize("case", ["rice 3048 x 1000", "ragged 1037 x 129", "rows with s = 0",
                                  "|F| past exp's range"])
def test_kernel_matches_plain_fp32(card, case):
    n, j, scale, zero_rows, q = CARD_SHAPES[case]
    f, rule = _card_inputs(n, j, torch.float32, scale, zero_rows, q)
    dc_gap, cost_gap = _gaps(f, rule, card)
    assert dc_gap <= 1e-5 and cost_gap <= 1e-5, (dc_gap, cost_gap)


@pytest.mark.card
@pytest.mark.parametrize("case", list(MIXED) + ["fp16-F-fp16-rule"])
def test_the_cost_sends_every_cuda_f_to_the_kernel(card, case):
    f_dtype, rule_dtype = MIXED.get(case, (torch.float16, torch.float16))
    f, rule = _card_inputs(517, 257, torch.float64, zero_std_rows=True)
    f, rule = f.to(card, f_dtype), [t.to(card, rule_dtype) for t in rule]
    cost = SmoothedBernoulliCost(*rule)
    before = sb.smoothed_bernoulli.launches
    if rule_dtype == torch.float16:  # the kernel takes fp32 and fp64 only
        with pytest.raises(ValueError, match="smoothed_bernoulli"):
            cost.calculate_cost_and_derivative(f)
        assert sb.smoothed_bernoulli.launches == before
        return
    got_cost, got_dc = cost.calculate_cost_and_derivative(f)
    assert sb.smoothed_bernoulli.launches == before + 1
    dtype = torch.promote_types(f_dtype, rule_dtype)  # the two methods' dtype
    assert got_cost.dtype == got_dc.dtype == cost.calculate_cost_derivative(f).dtype == dtype
    want_cost, want_dc = sb.smoothed_bernoulli_reference(f.to(dtype), *[t.to(dtype) for t in rule])
    dc_gap = float((got_dc - want_dc).abs().max() / want_dc.abs().max())
    cost_gap = float((got_cost - want_cost).abs().max() / want_cost.abs().max())
    limit = (1e-13, 1e-12) if dtype == torch.float64 else (1e-5, 1e-5)
    assert dc_gap <= limit[0] and cost_gap <= limit[1], (dc_gap, cost_gap)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["fp64", "fp32"])
def test_a_rerun_is_bitwise_equal(card, dtype):
    f, rule = _card_inputs(3048, 1000, dtype)
    f, rule = f.to(card), [t.to(card) for t in rule]
    first = sb.smoothed_bernoulli(f, *rule)
    for _ in range(3):
        again = sb.smoothed_bernoulli(f, *rule)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.card
def test_graphed_off_tier_counts_a_launch_a_step_and_matches_eager_plain(card, monkeypatch):
    steps, j = 300, 64  # more than a chunk, so two graphs' replays are counted
    basis, cost = _model("smoothed", n=600, m=30, device=card)
    u0 = torch.randn((basis.approximation_dimension, j), generator=torch.Generator().manual_seed(4),
                     dtype=torch.float64).to(card)
    before = sb.smoothed_bernoulli.launches
    got = training._train_pls_loop(basis, cost, u0, ETA, math.inf, steps, "off", generator=17,
                                   discretisation="preconditioned")
    torch.cuda.synchronize()
    assert early_stopper.last_run_stats.mode == "graph"
    assert sb.smoothed_bernoulli.launches - before == steps + 1  # state0, then one a step
    monkeypatch.setattr(SmoothedBernoulliCost, "calculate_cost_and_derivative",
                        PLSCostMixin.calculate_cost_and_derivative)
    with early_stopper._eager_on_card():
        plain = training._train_pls_loop(basis, cost, u0, ETA, math.inf, steps, "off",
                                         generator=17, discretisation="preconditioned")
    assert early_stopper.last_run_stats.mode == "eager"
    assert sb.smoothed_bernoulli.launches - before == steps + 1
    u_gap = float((got.particles - plain.particles).abs().max() / plain.particles.abs().max())
    e_gap = float((got.energies - plain.energies).abs().max() / plain.energies.abs().max())
    assert u_gap <= 1e-12 and e_gap <= 1e-12, (u_gap, e_gap)
