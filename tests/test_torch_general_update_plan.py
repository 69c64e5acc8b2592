"""The operand plan of B3's update (``ops/cuda/general_train.py``), in plain
PyTorch (CPU).

The kernel's ``wgmma`` update computes G^T = dc^T P: it reads P^T split once
into TF32 halves, K-major along N and zero-padded (``split_update_operand``),
splits dc's fragments in registers, and runs (tile, slice of N) work units in
a static order over a persistent grid, each tile's slices summed in slice
order (``update_plan``, ``update_schedule``). These tests hold the plan to
the product it stands for: the halves are ``tc_product.tf32_split``'s bit for
bit, the three products of the new operands are
``tc_product.tf32x3_matmul(P^T, dc)``'s to fp32 rounding, and the schedule
runs every (tile, slice) once, each slice a nonempty run of stages."""

import pytest
import torch

from projected_langevin_sampling_torch.ops.cuda import general_train as gen
from projected_langevin_sampling_torch.ops.cuda import tc_product

# the headline, rice's shape (M_k not a multiple of 8) and a ragged toy
SHAPES = [(5000, 512, 1000), (3048, 55, 1000), (37, 3, 5)]


def _operands(n, m_k, j, seed=0):
    gen_ = torch.Generator().manual_seed(seed)
    p = torch.randn((n, m_k), generator=gen_) * (2.0 / n) ** 0.5
    dc = torch.randn((n, j), generator=gen_)
    return p, dc


@pytest.mark.parametrize("n, m_k, j", SHAPES)
def test_update_schedule_runs_every_tile_and_slice_once_in_a_fixed_order(n, m_k, j):
    plan = gen.update_plan(n, m_k, j)
    rows = -(-j // gen.UPDATE_TILE_J)
    cols = -(-m_k // gen.UPDATE_TILE_M)
    stages = -(-n // gen.UPDATE_TILE_K)
    # one prior partial and one arrival counter a tile of the (J, M_k) output
    assert plan.tiles == rows * cols and plan.col_tiles == cols
    assert plan.depth == stages * gen.UPDATE_TILE_K and n <= plan.depth < n + gen.UPDATE_TILE_K
    assert 1 <= plan.slices <= gen.UPDATE_MAX_SLICES
    assert plan.grid == min(gen.H100_SMS, plan.tiles * plan.slices)
    # a cut tile's units wait for each other: all of them run at once
    assert plan.slices == 1 or plan.tiles * plan.slices <= gen.H100_SMS
    schedule = gen.update_schedule(plan)
    assert len(schedule) == plan.grid
    units = [u for block in schedule for u in block]
    assert sorted((r, c, s) for r, c, s, _, _ in units) == [
        (r, c, s) for r in range(rows) for c in range(cols) for s in range(plan.slices)]
    # block b runs units b, b + grid, ...: unit = slice * tiles + row * cols + col
    for b, block in enumerate(schedule):
        assert [s * plan.tiles + r * cols + c for r, c, s, _, _ in block] == list(
            range(b, plan.tiles * plan.slices, plan.grid))
    # each tile's slices cut the stages of N into nonempty runs, in slice order
    for r in range(rows):
        for c in range(cols):
            runs = sorted((s, first, end) for rr, cc, s, first, end in units
                          if (rr, cc) == (r, c))
            assert runs[0][1] == 0 and runs[-1][2] == stages
            assert all(first < end for _, first, end in runs)
            assert all(a[2] == b[1] for a, b in zip(runs, runs[1:]))
    assert schedule == gen.update_schedule(plan)


@pytest.mark.parametrize("n, m_k, j", SHAPES)
def test_update_operand_is_p_transposed_tf32_halves_k_major_and_zero_padded(n, m_k, j):
    p, _ = _operands(n, m_k, j)
    k, depth = gen.forward_plan(n, m_k, j).k, gen.update_plan(n, m_k, j).depth
    pt_split = gen.split_update_operand(p, k, depth)
    assert pt_split.shape == (2, k, depth)
    assert pt_split.is_contiguous() and pt_split.dtype == torch.float32
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    hi, lo = tc_product.tf32_split(p.T.contiguous())
    assert torch.equal(bits(pt_split[0, :m_k, :n]), bits(hi))
    assert torch.equal(bits(pt_split[1, :m_k, :n]), bits(lo))
    # zero in the padded rows of M_k and the padded columns of N
    assert not bits(pt_split[:, m_k:, :]).any() and not bits(pt_split[:, :, n:]).any()


@pytest.mark.parametrize("n, m_k, j", SHAPES)
def test_update_operands_multiply_as_the_3xtf32_product(n, m_k, j):
    p, dc = _operands(n, m_k, j, seed=1)
    plan = gen.update_plan(n, m_k, j)
    pt_split = gen.split_update_operand(p, gen.forward_plan(n, m_k, j).k, plan.depth)
    got = gen.update_product(dc, pt_split, m_k)
    want = tc_product.tf32x3_matmul(p.T.contiguous(), dc)
    assert got.shape == (m_k, j)
    # the same terms, which the CPU's matmul may sum in another order: within
    # the fp32 rounding of sums of n terms
    scale = float((p.T.abs() @ dc.abs()).max())
    assert float((got - want).abs().max()) <= n * 2.0**-24 * scale


def test_dc_pitch_gives_tma_a_16_byte_stride():
    assert [gen.dc_pitch(j) for j in (1, 4, 5, 1000, 1001)] == [4, 4, 8, 1000, 1004]
