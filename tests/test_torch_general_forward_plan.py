"""The operand plan of B3's forward sweep (``ops/cuda/general_train.py``),
in plain PyTorch (CPU).

The kernel's ``wgmma`` forward reads P and U^T split once into TF32 halves,
K-major and zero-padded in depth (``split_operands``), and runs its 64 x 128
tiles in a static order over a persistent grid (``forward_plan``,
``forward_schedule``). These tests hold the plan to the product it stands
for: the halves are ``tc_product.tf32_split``'s bit for bit, their three
products are ``tc_product.tf32x3_matmul``'s, and the schedule runs every
tile once, one cost partial each."""

import pytest
import torch

from projected_langevin_sampling_torch.ops.cuda import general_train as gen
from projected_langevin_sampling_torch.ops.cuda import tc_product

# the headline, rice's shape (M_k not a multiple of 8) and a ragged toy
SHAPES = [(5000, 512, 1000), (3048, 55, 1000), (37, 3, 5)]


def _operands(n, m_k, j, seed=0):
    gen_ = torch.Generator().manual_seed(seed)
    p = torch.randn((n, m_k), generator=gen_) * (2.0 / n) ** 0.5
    u = torch.randn((m_k, j), generator=gen_)
    return p, u


@pytest.mark.parametrize("n, m_k, j", SHAPES)
def test_split_operands_are_the_tf32_halves_k_major_and_zero_padded(n, m_k, j):
    p, u = _operands(n, m_k, j)
    plan = gen.forward_plan(n, m_k, j)
    assert plan.k % gen.FORWARD_TILE_K == 0 and m_k <= plan.k < m_k + gen.FORWARD_TILE_K
    p_split, ut_split = gen.split_operands(p, u, plan.k)
    assert p_split.shape == (2, n, plan.k) and ut_split.shape == (2, j, plan.k)
    for split, x in ((p_split, p), (ut_split, u.T)):
        assert split.is_contiguous() and split.dtype == torch.float32
        hi, lo = tc_product.tf32_split(x.contiguous())
        bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
        assert torch.equal(bits(split[0, :, :m_k]), bits(hi))
        assert torch.equal(bits(split[1, :, :m_k]), bits(lo))
        assert torch.equal(bits(split[:, :, m_k:]), torch.zeros_like(bits(split[:, :, m_k:])))


@pytest.mark.parametrize("n, m_k, j", SHAPES)
def test_split_operands_multiply_as_the_3xtf32_product(n, m_k, j):
    p, u = _operands(n, m_k, j, seed=1)
    p_split, ut_split = gen.split_operands(p, u, gen.forward_plan(n, m_k, j).k)
    assert torch.equal(gen.forward_product(p_split, ut_split), tc_product.tf32x3_matmul(p, u))


@pytest.mark.parametrize("n, m_k, j", SHAPES)
def test_forward_schedule_runs_every_tile_once_in_a_fixed_order(n, m_k, j):
    plan = gen.forward_plan(n, m_k, j)
    rows, cols = -(-n // tc_product.TILE_M), -(-j // tc_product.TILE_N)
    # one cost partial a tile, as many as the wrapper allocates (tc_product.tiles)
    assert plan.tiles == rows * cols == tc_product.tiles(n, j)
    assert plan.col_tiles == cols and plan.grid == min(gen.H100_SMS, plan.tiles)
    schedule = gen.forward_schedule(plan)
    assert len(schedule) == plan.grid
    seen = [t for block in schedule for t in block]
    assert sorted(seen) == [(r, c) for r in range(rows) for c in range(cols)]
    # block b runs tiles b, b + grid, ...: the partial index t = r cols + c
    for b, block in enumerate(schedule):
        assert [r * cols + c for r, c in block] == list(range(b, plan.tiles, plan.grid))
    # the last round is as full as the tile count allows
    assert max(map(len, schedule)) == -(-plan.tiles // plan.grid)
    assert schedule == gen.forward_schedule(plan)
