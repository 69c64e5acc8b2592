"""The arithmetic of the tensor-core product of B3 and B5
(``csrc/tc_product.cuh``), emulated in plain PyTorch by
``ops/cuda/tc_product.py`` (CPU), and the tiling the wrappers size their
scratch from.

1. ``tf32_rna`` against hand-worked bit patterns: to nearest, ties away from
   zero (``cvt.rna.tf32.f32``), both signs, subnormals, overflow, inf, NaN.
2. The 3xTF32 product against fp64 on seeded numpy inputs: its error, in
   units of |A| |B|, stays within 2x an fp32 ``torch.matmul``'s, while a
   1xTF32 product's is over 100x: the reason for the split.
3. B3's plain version with the emulated product in place of its two matmuls
   stays inside the tolerances ``chip_smoke.py`` holds the kernel to
   (``W_TOL`` 1e-3 of max|U|, ``E_RTOL`` 1e-5 on the energies) against the
   fp32 plain version, for every cost kind under every discretisation; the
   1xTF32 product breaks ``E_RTOL`` on the Gaussian kind.
4. ``split_k``: every slice of a split holds depth, the slices cover it,
   and the headline shapes give the blocks the source notes state."""

import math

import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.ops.cuda import cost_forms
from projected_langevin_sampling_torch.ops.cuda import general_train as tgen
from projected_langevin_sampling_torch.ops.cuda import tc_product as tc

W_TOL, E_RTOL = 1e-3, 1e-5  # chip_smoke.py's B3 tolerances


def _bits(x: float) -> int:
    return int(torch.tensor([x], dtype=torch.float32).view(torch.int32)[0]) & 0xFFFFFFFF


def _from_bits(b: int) -> torch.Tensor:
    signed = b - (1 << 32) if b >= 1 << 31 else b
    return torch.tensor([signed], dtype=torch.int32).view(torch.float32)


@pytest.mark.parametrize("x_bits, expected_bits", [
    (0x3F800000, 0x3F800000),  # 1.0 is TF32
    (0x3F800FFF, 0x3F800000),  # just below half a unit: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (ties-to-even gives 1.0)
    (0x3F801001, 0x3F802000),  # just above half a unit: up
    (0x3F803000, 0x3F804000),  # 1 + 3 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero, so down
    (0xBF800FFF, 0xBF800000),  # negative, below half a unit: towards zero
    (0x3FFFF000, 0x40000000),  # a tie that carries into the exponent
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x80000FFF, 0x80000000),  # a negative subnormal rounds to -0
    (0x7F7FFFFF, 0x7F800000),  # past TF32's largest finite value: infinity
    (0x7F800000, 0x7F800000),  # inf stays
    (0xFF800000, 0xFF800000),  # -inf stays
])
def test_tf32_rna_matches_hand_worked_bit_patterns(x_bits, expected_bits):
    got = tc.tf32_rna(_from_bits(x_bits))
    assert _bits(float(got[0])) == expected_bits


def test_tf32_rna_keeps_nan_and_shape():
    x = torch.tensor([[math.nan, 1.0], [-2.5, 0.1]], dtype=torch.float32)
    got = tc.tf32_rna(x)
    assert got.shape == x.shape and bool(torch.isnan(got[0, 0]))
    assert float(got[0, 1]) == 1.0 and float(got[1, 0]) == -2.5  # already TF32
    assert 0 < abs(float(got[1, 1]) - float(x[1, 1])) <= 2.0**-11 * 0.1
    with pytest.raises(TypeError, match="fp32 only"):
        tc.tf32_rna(x.double())


def test_split_is_exact_to_two_to_the_minus_22():
    x = torch.tensor(np.random.default_rng(3).normal(size=10_000), dtype=torch.float32)
    hi, lo = tc.tf32_split(x)
    assert torch.equal(tc.tf32_rna(hi), hi) and torch.equal(tc.tf32_rna(lo), lo)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0**-22


@pytest.mark.parametrize("m, k, n, seed", [(64, 512, 48, 0), (128, 1000, 64, 1),
                                           (40, 5000, 30, 2), (33, 77, 17, 3)])
def test_3xtf32_product_error_is_fp32_level(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()

    def err(c):
        return float(((c.double() - exact).abs() / scale).max())

    fp32, three, one = err(a @ b), err(tc.tf32x3_matmul(a, b)), err(tc.tf32_matmul(a, b))
    assert three <= 2.0 * fp32, (three, fp32)
    assert one >= 100.0 * fp32, (one, fp32)


def _problem(kind, n=300, m_k=64, j=48, seed=0):
    """chip_smoke.py's synthetic_general at a small size, from numpy: a dense
    random projection, prior eigenvalues in (0.5, 2), prior draws as U0 and
    targets of sin(2x)."""
    rng = np.random.default_rng(seed)
    f = np.sin(2 * np.sort(rng.uniform(-3, 3, n)))
    labels = (f + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    p = rng.normal(size=(n, m_k)) * math.sqrt(2.0 / n)
    lam = 0.5 + 1.5 * rng.uniform(size=m_k)
    u0 = np.sqrt(lam)[:, None] * rng.normal(size=(m_k, j))
    params, mean_shift, aux = (0.0, 0.0, 0.0), 0.0, None
    if kind == "gaussian":
        y, params = f + 0.1 * rng.normal(size=n), (0.1, 0.0, 0.0)
    elif kind in ("bernoulli_sigmoid", "bernoulli_probit"):
        y = labels
    elif kind == "bernoulli_sigmoid_smoothed":
        y, aux = labels, rng.uniform(0.3, 1.2, n)
    elif kind == "poisson_square":
        y, mean_shift, u0 = rng.poisson((3.0 + f) ** 2).astype(np.float64), 3.0, 0.2 * u0
    elif kind == "student_t":
        y, params = f + 0.1 * rng.standard_t(4.0, size=n), (4.0, 0.3, 0.0)
    else:
        y, params = f - 2.0 * (rng.uniform(size=n) < 0.4), (0.3, 2.0, 0.4)
    as_t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return dict(p=as_t(p), u0=as_t(u0), y=as_t(y), eigenvalues=as_t(lam), kind=kind,
                params=params, mean_shift=mean_shift, aux=None if aux is None else as_t(aux))


def _run(kind, discretisation, product):
    return tgen.general_train_reference(
        **_problem(kind), eta=1e-3, patience=math.inf, num_steps=20,
        discretisation=discretisation, zero_noise=True, product=product)


@pytest.mark.parametrize("kind, discretisation", [
    (kind, disc) for kind in cost_forms.COST_KINDS for disc in tgen.DISCRETISATIONS])
def test_b3_plain_version_with_3xtf32_holds_the_chip_tolerances(kind, discretisation):
    u, e, rec, steps = _run(kind, discretisation, torch.matmul)
    u3, e3, rec3, steps3 = _run(kind, discretisation, tc.tf32x3_matmul)
    scale = max(1.0, float(u.abs().max()))
    assert float((u3 - u).abs().max()) <= W_TOL * scale
    assert float(((e3 - e).abs() / e.abs()).max()) <= E_RTOL
    assert int(steps3) == int(steps) == 20 and bool(rec3.all())


def test_b3_plain_version_with_1xtf32_breaks_the_energy_tolerance():
    _, e, _, _ = _run("gaussian", "euler", torch.matmul)
    _, e1, _, _ = _run("gaussian", "euler", tc.tf32_matmul)
    assert float(((e1 - e).abs() / e.abs()).max()) > E_RTOL


@pytest.mark.parametrize("rows, cols, depth", [
    (512, 1000, 5000), (512, 1000, 5024 + 512), (128, 256, 1000), (32, 1000, 1000),
    (12, 16, 50), (1, 1, 1), (300, 7, 4097), (5000, 1000, 512)])
def test_split_k_slices_cover_the_depth(rows, cols, depth):
    split = tc.split_k(rows, cols, depth)
    assert split.tiles == math.ceil(rows / tc.TILE_M) * math.ceil(cols / tc.TILE_N)
    per = math.ceil(math.ceil(depth / split.slices) / tc.TILE_K) * tc.TILE_K  # tc::slice_depth
    assert per % tc.TILE_K == 0 and (split.slices - 1) * per < depth <= split.slices * per
    assert split.slab == (split.slices * split.tiles * tc.TILE_M * tc.TILE_N
                          if split.slices > 1 else 0)
    if split.slices > 1:
        assert per >= tc.MIN_SLICE_STAGES * tc.TILE_K


def test_split_k_at_the_headline():
    # B3's update: (M_k, J) = (512, 1000) over N = 5000; B5's with the matrix
    # prior over N rounded up to a stage plus M
    assert tc.split_k(512, 1000, 5000) == (64, 4, 4 * 64 * 64 * 128)
    assert tc.split_k(512, 1000, 5024 + 512) == (64, 4, 4 * 64 * 64 * 128)
    assert tc.tiles(5000, 1000) == 632
