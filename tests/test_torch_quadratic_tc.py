"""B4 on the tensor cores (``csrc/quadratic_train.cu``), checked on the CPU
through its plain version and the mirror of its persistent partition.

1. B4's plain version with its products replaced by the emulated 3xTF32
   product (``ops/cuda/tc_product.py``) stays inside the tolerances
   ``chip_smoke.py`` phase 8 holds the kernel to (``W_TOL`` 1e-3 of max|U|,
   ``E_RTOL`` 1e-5 on the energies) against the fp64 plain version, for the
   shared (ONB) and the non-shared (IPB) system of bench.py's recipe at a
   small size, with zero and with injected noise; a 1xTF32 product breaks
   ``E_RTOL``. (On a system whose converged energy is a small difference of
   large terms the relative error of any fp32 energy grows with the
   cancellation, for fp32 products too: the recipe's lengthscale keeps
   k(Z, Z) near I, as at the headline.)
2. The partition (``persistent_phase``, ``persistent_grid``,
   ``block_items``): every (product, tile, slice) of a step is owned by
   exactly one block, at the headline and at ragged shapes, for any
   co-resident count, and the grid never exceeds the count it is given."""

import math

import numpy as np
import pytest
import torch

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch import training as ttrain
from projected_langevin_sampling_torch.ops.cuda import quadratic_train as tquad
from projected_langevin_sampling_torch.ops.cuda import tc_product as tc

W_TOL, E_RTOL = 1e-3, 1e-5  # chip_smoke.py's B4 tolerances
N_TC, M_TC, J_TC, T, ETA = 500, 64, 16, 200, 1e-4


def _system(which):
    """fp64 quadratic system, U0 and normals of bench.py's build() at N=500,
    M=64: sorted X on [-3, 3], Z = linspace(-3, 3, M), lengthscale 0.01,
    observation noise 0.1; the ONB is shared, the IPB (y(Z) = sin 2Z) not."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, (N_TC, 1)), axis=0)
    y = np.sin(2 * x[:, 0]) + 0.2 * rng.normal(size=N_TC)
    x, y, z = (torch.tensor(a) for a in (x, y, np.linspace(-3, 3, M_TC)[:, None]))
    kernel = pt.PLSKernel(
        base_kernel=pt.ARDKernel(lengthscales=torch.tensor([0.01], dtype=torch.float64),
                                 outputscale=torch.tensor(1.0, dtype=torch.float64)),
        approximation_samples=x,
    )
    if which == "onb":
        basis = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    else:
        basis = pt.build_inducing_point_basis(kernel, z, torch.sin(2 * z[:, 0]), x)
    cost = pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, dtype=torch.float64))
    a, b, e_mat, e_bias, e_const, shared = ttrain._quadratic_system(basis, cost)
    assert bool(shared) == (which == "onb") and a.shape == (M_TC, M_TC)
    u0 = torch.tensor(rng.normal(size=(a.shape[0], J_TC)), dtype=torch.float64)
    noise = torch.tensor(rng.normal(size=(T, a.shape[0], J_TC)), dtype=torch.float64)
    args = (a, b, e_mat, e_bias, None if shared else basis.noise_factor, u0)
    return args, dict(e_const=float(e_const), shared=bool(shared)), noise


def _run(args, kw, noise, dtype, product):
    cast = [None if t is None else t.to(dtype) for t in args]
    return tquad.quadratic_train_reference(
        *cast, **kw, eta=ETA, patience=math.inf, num_steps=T, zero_noise=noise is None,
        noise=None if noise is None else noise.to(dtype), product=product)


@pytest.mark.parametrize("which", ["onb", "ipb"])
@pytest.mark.parametrize("noisy", [False, True])
def test_plain_version_with_3xtf32_holds_the_chip_tolerances_against_fp64(which, noisy):
    args, kw, noise = _system(which)
    noise = noise if noisy else None
    u, e, rec, steps = _run(args, kw, noise, torch.float64, torch.matmul)
    u3, e3, rec3, steps3 = _run(args, kw, noise, torch.float32, tc.tf32x3_matmul)
    scale = max(1.0, float(u.abs().max()))
    assert float((u3.double() - u).abs().max()) <= W_TOL * scale
    assert float(((e3.double() - e).abs() / e.abs()).max()) <= E_RTOL
    assert int(steps3) == int(steps) == T and bool(rec3.all())


def test_plain_version_with_1xtf32_breaks_the_energy_tolerance():
    args, kw, _ = _system("ipb")
    _, e, _, _ = _run(args, kw, None, torch.float64, torch.matmul)
    _, e1, _, _ = _run(args, kw, None, torch.float32, tc.tf32_matmul)
    assert float(((e1.double() - e).abs() / e.abs()).max()) > E_RTOL


def test_reference_product_defaults_to_matmul():
    args, kw, noise = _system("ipb")
    got = tquad.quadratic_train_reference(*args, **kw, eta=ETA, patience=math.inf, num_steps=5,
                                          noise=noise)
    explicit = tquad.quadratic_train_reference(*args, **kw, eta=ETA, patience=math.inf,
                                               num_steps=5, noise=noise, product=torch.matmul)
    assert torch.equal(got[0], explicit[0]) and torch.equal(got[1], explicit[1])


CONFIGS = [(True, False), (False, False), (False, True)]  # (shared, zero_noise)


@pytest.mark.parametrize("m, j", [(512, 1000), (100, 37), (513, 1000)])
@pytest.mark.parametrize("shared, zero_noise", CONFIGS)
@pytest.mark.parametrize("coresident", [tc.BLOCK_SLOTS, 132, 7])
def test_every_item_has_exactly_one_owner(m, j, shared, zero_noise, coresident):
    phase = tquad.phase(m, j, shared, zero_noise)
    grid = tc.persistent_grid(phase, coresident)
    assert 1 <= grid <= coresident and grid <= phase.items
    assert phase.tiles == tc.tiles(m, j)
    assert phase.products == (1 if shared else 2 if zero_noise else 3)
    assert phase.items == phase.products * phase.slices * phase.tiles
    assert phase.slab == phase.items * tc.TILE_M * tc.TILE_N
    owners = {}
    for block in range(grid):
        for item in tc.block_items(block, grid, phase):
            assert item not in owners, (item, block, owners.get(item))
            owners[item] = block
    assert set(owners) == {(p, t, s) for p in range(phase.products)
                           for t in range(phase.tiles) for s in range(phase.slices)}
    # every slice holds depth (tc::slice_depth), and the slices cover M
    per = math.ceil(math.ceil(m / phase.slices) / tc.TILE_K) * tc.TILE_K
    assert (phase.slices - 1) * per < m <= phase.slices * per


def test_partition_at_the_headline():
    # 64 tiles of 64 x 128. Non-shared with noise: A U, E U and S eps in 4
    # slices of 128 each (768 items, 3 a block); one slice of 512 (192 items)
    # or two of 256 (384) would leave a block 512 deep. Shared: A U in 4
    # slices, one item a block.
    phase = tquad.phase(512, 1000, shared=False, zero_noise=False)
    assert (phase.tiles, phase.products, phase.slices, phase.items) == (64, 3, 4, 768)
    assert tc.persistent_grid(phase) == tc.BLOCK_SLOTS
    assert tquad.phase(512, 1000, shared=False, zero_noise=True)[1:4] == (2, 2, 256)
    shared = tquad.phase(512, 1000, shared=True, zero_noise=False)
    assert shared[1:4] == (1, 4, 256) and tc.persistent_grid(shared) == 256
    # a deep system keeps few slices: the slabs grow with every slice
    assert tquad.phase(2048, 1000, shared=False, zero_noise=False).slices == 1
