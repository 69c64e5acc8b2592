"""B3's ``wgmma`` update on the card (skipped without CUDA; run there with
``python -m pytest tests/test_torch_general_update_card.py -m card
--noconftest``).

The kernel (``csrc/general_train.cu``, ``update_kernel``: G^T = dc^T P on
``wgmma``, split-K in slice order, the update with Philox noise) against the
plain loop (``general_train_reference``) fed the kernel's own normals, rebuilt
from the seed by ``benchmark/reference/pls_philox.normals``: all three
discretisations, rice's M_k = 55 (one M_k tile, padded depth), a column shard
at j0 = 128 and a run that stops. Two runs with one seed are equal bit for
bit, and every step of a run counts as a ``wgmma`` update."""

import math

import pytest
import torch

STEPS, ETA, SEED = 50, 1e-3, 2**33 + 12345
# kernel against plain loop, both fp32, products and sums in other orders: 50
# contracting steps keep the gap near fp32 rounding of |U| (chip_smoke.py
# phase 6's W_TOL and E_RTOL)
W_TOL, E_RTOL = 1e-3, 1e-5
CASES = {  # kind, N, M_k, J, discretisation, shard (j0, j_total), eta, steps
    "euler": ("bernoulli_sigmoid_smoothed", 1000, 128, 256, "euler", None, ETA, STEPS),
    "exponential": ("bernoulli_sigmoid_smoothed", 1000, 128, 256, "exponential", None, ETA,
                    STEPS),
    "preconditioned": ("bernoulli_sigmoid_smoothed", 1000, 128, 256, "preconditioned", None,
                       ETA, STEPS),
    "rice M_k=55": ("student_t", 3048, 55, 1000, "preconditioned", None, ETA, STEPS),
    "shard j0=128": ("gaussian", 1000, 128, 256, "exponential", (128, 768), ETA, STEPS),
    "stopped": ("gaussian", 1000, 128, 256, "euler", None, 50.0, 20),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_general_update_card.py -m card --noconftest)")
    return torch.device("cuda")


def _problem(kind, n, m_k, j, device, seed=5):
    """A dense random projection with P^T P about 2 I, prior eigenvalues in
    (0.5, 2), prior draws as U0, and targets of sin(2x) on sorted x."""
    from projected_langevin_sampling_torch.ops.cuda.general_train import JITTER

    gen_ = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.sort(6.0 * torch.rand(n, generator=gen_, dtype=torch.float64) - 3.0).values
    f = torch.sin(2.0 * x)
    noise = torch.randn(n, generator=gen_, dtype=torch.float64)
    p = torch.randn((n, m_k), generator=gen_) * math.sqrt(2.0 / n)
    lam = 0.5 + 1.5 * torch.rand(m_k, generator=gen_)
    u0 = torch.sqrt(lam)[:, None] * torch.randn((m_k, j), generator=gen_)
    params, aux = (0.0, 0.0, 0.0), None
    if kind == "gaussian":
        y, params = f + 0.1 * noise, (0.1, 0.0, 0.0)
    elif kind == "student_t":
        y, params = f + 0.1 * noise, (4.0, 0.3, 0.0)
    elif kind == "bernoulli_sigmoid_smoothed":
        y = (f + 0.2 * noise > 0).double()
        aux = 0.3 + 0.9 * torch.rand(n, generator=gen_, dtype=torch.float64)
        params = (JITTER, 0.0, 0.0)
    else:
        raise ValueError(kind)
    to = lambda t: None if t is None else t.to(device, torch.float32)  # noqa: E731
    return dict(p=to(p), u0=to(u0), y=to(y), eigenvalues=to(lam), kind=kind, params=params,
                aux=to(aux))


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_the_plain_loop_on_the_kernels_normals(case):
    from benchmark.reference.pls_philox import normals
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen
    from projected_langevin_sampling_torch.utils.columns import ColumnShard

    device = _card()
    kind, n, m_k, j, disc, shard, eta, steps = CASES[case]
    prob = _problem(kind, n, m_k, j, device)
    shard = None if shard is None else ColumnShard(j0=shard[0], j_total=shard[1])
    kw = dict(prob, eta=eta, patience=math.inf, num_steps=steps, discretisation=disc,
              shard=shard)
    before = gen.general_train.launches
    u_k, e_k, rec_k, s_k = gen.general_train(**kw, seed=SEED)
    assert gen.general_train.launches == before + 1
    j0, j_total = (0, j) if shard is None else (shard.j0, shard.j_total)
    eps = normals(SEED, m_k, j_total, 0, steps, device)[:, :, j0:j0 + j].float()
    u_p, e_p, rec_p, s_p = gen.general_train_reference(**kw, noise=eps)
    torch.cuda.synchronize()
    if case == "stopped":  # the same stop, NaN tail and frozen particles
        assert 1 < int(s_k) == int(s_p) < steps
        assert torch.equal(rec_k, rec_p)
        assert torch.equal(torch.isnan(e_k), torch.isnan(e_p))
        finite = torch.isfinite(u_p)
        assert torch.equal(finite, torch.isfinite(u_k)) and bool(finite.any())
        scale = float(u_p[finite].abs().max())
        assert float((u_k[finite] - u_p[finite]).abs().max()) <= 1e-4 * scale
        return
    assert int(s_k) == int(s_p) == steps and bool(rec_k.all())
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u_k - u_p).abs().max()) <= W_TOL * scale
    assert float(((e_k - e_p) / e_p).abs().max()) <= E_RTOL


@pytest.mark.card
def test_two_runs_with_one_seed_are_bitwise_equal():
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen

    device = _card()
    prob = _problem("bernoulli_sigmoid_smoothed", 1000, 128, 256, device)
    assert gen.update_plan(1000, 128, 256).slices > 1  # the split-K sum is exercised
    kw = dict(prob, eta=ETA, patience=math.inf, num_steps=STEPS,
              discretisation="preconditioned", seed=SEED)
    u1, e1, _, _ = gen.general_train(**kw)
    u2, e2, _, _ = gen.general_train(**kw)
    assert torch.equal(u1, u2) and torch.equal(e1, e2)


@pytest.mark.card
def test_every_step_of_a_call_is_a_wgmma_update():
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen

    device = _card()
    prob = _problem("gaussian", 1000, 128, 256, device)
    before = gen.general_train.steps, gen.general_train.update_wgmma_steps
    gen.general_train(**prob, eta=ETA, patience=math.inf, num_steps=7)
    torch.cuda.synchronize()
    after = gen.general_train.steps, gen.general_train.update_wgmma_steps
    assert after[0] - before[0] == after[1] - before[1] == 7
