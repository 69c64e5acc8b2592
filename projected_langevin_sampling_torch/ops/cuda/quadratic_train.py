"""B4: the whole-run quadratic-tier trainer (``csrc/quadratic_train.cu``) and
its plain version.

Replaces ``projected_langevin_sampling_tpu/ops/pallas/quadratic_train.py``
(``quadratic_train_fused``). For the Gaussian cost with the identity link, in
M space, for T steps:

    U' = U - eta (A U - b) + sqrt(2 eta) S eps
    energy_t = mean_j(0.5 U'^T E U' - e_bias . U') + e_const

with the reference's early stopping: the stop step's update is applied and
its energy written but not recorded, the particles freeze after it and later
energies are NaN. ``shared`` (the orthonormal basis: E == A, S == I) carries
V = A U, so a step is one product; otherwise (the inducing-point basis, S its
noise factor) three.

Bound on the H100: operations, 2 M^2 J flops per product, run as three TF32
products on the tensor cores (3xTF32, ``csrc/tc_product.cuh``: fp32-level
error), plus about 41 per element of U (Philox, Box-Muller, the update, the
energy) on the CUDA cores; A, E, S and U stay in L2. The kernel is one
cooperative launch a run on the current stream, whatever T: a persistent
grid of the blocks the card holds at once, one phase of products and one
grid-wide barrier a step, the stopper state on the card. Its work items,
and the scratch they need, come from :func:`phase`; each block runs each of
its items through the product's ring of asynchronous copies.

:func:`quadratic_train` launches the kernel for CUDA tensors, in fp32 with a
cast at entry and exit, and runs :func:`quadratic_train_reference` only for
tensors that lie on the CPU. ``quadratic_train.launches`` counts whole runs.

A ``shard`` (:class:`~projected_langevin_sampling_torch.utils.columns.ColumnShard`)
runs columns j0 .. j0 + J_loc of a J-column run, as B3's does
(``ops/cuda/general_train.py``): Philox groups counted on the run's column
(j0 a multiple of 4), energies the shard's share (the constant's too), run
with infinite patience and the run's stop taken by ``parallel/auto.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from projected_langevin_sampling_torch.ops.cuda import build, tc_product
from projected_langevin_sampling_torch.utils.columns import (
    ColumnShard,
    column_mean,
    column_normals,
    constant_share,
)
from projected_langevin_sampling_torch.utils.early_stopper import (
    replay_early_stopper,
    run_training,
    take,
)

# fp32 operations per element of U and step besides the products, for the
# bound in PERF.md and chip_smoke.py: Philox and Box-Muller (31, as B1), the
# update (4) and the energy term (6)
OPS_PER_ELEMENT_STEP = 31 + 4 + 6

_SIGNATURES = {
    "plst_quadratic_train": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "plst_quadratic_coresident": [ctypes.POINTER(ctypes.c_int)],
    "plst_quadratic_record": [ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong)],
}


def step_operations(m: int, j: int, shared: bool) -> int:
    """fp32 operations of one training step, for the bound."""
    products = 1 if shared else 3
    return products * 2 * m * m * j + OPS_PER_ELEMENT_STEP * m * j


def phase(m: int, j: int, shared: bool, zero_noise: bool) -> tc_product.Phase:
    """The work items of one step of the kernel: A U and, when not shared,
    E U and (with noise) S eps, each cut into the same slices of the depth M."""
    return tc_product.persistent_phase(m, j, m, products=1 if shared else 2 if zero_noise else 3)


def coresident_blocks(device=None) -> int:
    """Blocks of the run kernel that the card holds at once: the largest grid
    its cooperative launch takes."""
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        lib = build.load("quadratic_train", _SIGNATURES)
        build.check(lib.plst_quadratic_coresident(ctypes.byref(blocks)), "quadratic_train blocks")
    return blocks.value


def record(device=None) -> tuple[int, float]:
    """The card's own record of the run kernel: the runs it has started on
    the device so far and the device milliseconds of the last one (block 0's
    start to its end). Waits for the device."""
    with torch.cuda.device(device):
        runs, last_ns = ctypes.c_ulonglong(0), ctypes.c_longlong(0)
        lib = build.load("quadratic_train", _SIGNATURES)
        build.check(lib.plst_quadratic_record(ctypes.byref(runs), ctypes.byref(last_ns)),
                    "quadratic_train record")
    return runs.value, last_ns.value / 1e6


def quadratic_train_reference(
    a: torch.Tensor,
    b: torch.Tensor,
    energy_matrix: torch.Tensor,
    energy_bias: torch.Tensor,
    noise_factor: torch.Tensor | None,
    u0: torch.Tensor,
    *,
    eta: float,
    patience: float,
    e_const,
    num_steps: int,
    shared: bool,
    zero_noise: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    product=torch.matmul,
    shard: ColumnShard | None = None,
):
    """The plain PyTorch loop over T doing the kernel's math in the input's
    dtype, with the early-stopper carry.

    Noise per step: zeros with ``zero_noise``; else ``S @ noise[t]`` for
    injected standard normals ``noise`` (T, M, J), the z of the basis's
    update noise S z (S = I when ``noise_factor`` is None; a shard's own
    columns); else normals from ``generator`` (a shard's columns of the
    whole draw). ``product`` computes A U, S z and E U (the tests put the
    emulation of the kernel's 3xTF32 product there). Returns ``(u, energies,
    recorded, steps_run)``."""
    dtype, device = u0.dtype, u0.device
    root2eta = math.sqrt(2.0 * eta)
    b_col = b[:, None]
    mat = a if shared else energy_matrix

    def step(t, state):
        # shared: v carries A u, one product serves this drift and the last energy
        u, v = state
        drift = (v if shared else product(a, u)) - b_col
        u_new = u - eta * drift
        if not zero_noise:
            z = take(noise, t) if noise is not None else column_normals(
                u.shape, generator, dtype, device, shard
            )
            eps = z if noise_factor is None else product(noise_factor, z)
            u_new = u_new + root2eta * eps
        v_new = product(mat, u_new)
        energy_j = 0.5 * torch.sum(u_new * v_new, dim=0) - energy_bias @ u_new + e_const
        return (u_new, v_new), column_mean(energy_j, shard)

    v0 = product(a, u0) if shared else torch.zeros_like(u0)
    run = run_training(step, (u0, v0), num_steps, eta, patience, dtype, device, graph=False)
    return run.state[0], run.energies, run.recorded, run.steps_run


def quadratic_train(
    a: torch.Tensor,
    b: torch.Tensor,
    energy_matrix: torch.Tensor,
    energy_bias: torch.Tensor,
    noise_factor: torch.Tensor | None,
    u0: torch.Tensor,
    *,
    eta: float,
    patience: float,
    e_const,
    num_steps: int,
    shared: bool,
    seed: int = 0,
    zero_noise: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    shard: ColumnShard | None = None,
):
    """Run ``num_steps`` quadratic-tier steps; returns ``(u, energies,
    recorded, steps_run)`` in ``u0``'s dtype.

    On CUDA tensors the kernel runs in fp32 with Philox noise keyed on
    ``seed``; injected ``noise`` is refused there and ``generator`` serves only
    the plain loop. ``zero_noise`` switches the noise off for exact comparison
    with the plain version. ``shard``: the columns of a J-column run these
    particles are (module note). On CPU tensors the plain loop runs."""
    if u0.device.type == "cpu":
        return quadratic_train_reference(
            a, b, energy_matrix, energy_bias, noise_factor, u0, eta=eta, patience=patience,
            e_const=e_const, num_steps=num_steps, shared=shared, zero_noise=zero_noise,
            noise=noise, generator=generator, shard=shard,
        )
    if u0.device.type != "cuda":
        raise ValueError(f"quadratic_train: particles on {u0.device}")
    if noise is not None:
        raise ValueError("quadratic_train: the kernel draws its own Philox noise; "
                         "injected noise is for CPU tensors")
    if u0.ndim != 2:
        raise ValueError(f"quadratic_train: particles of shape {tuple(u0.shape)}")
    m, j = u0.shape
    if shared and noise_factor is not None:
        raise ValueError("quadratic_train: a shared system has iid noise (noise_factor None)")
    if not shared and noise_factor is None and not zero_noise:
        raise ValueError("quadratic_train: a non-shared system needs its noise factor")
    for name, t, shape in (("A", a, (m, m)), ("E", energy_matrix, (m, m)), ("b", b, (m,)),
                           ("e_bias", energy_bias, (m,)), ("S", noise_factor, (m, m))):
        if t is not None and (t.shape != shape or t.device != u0.device):
            raise ValueError(f"quadratic_train: {name} of shape {tuple(t.shape)} on {t.device}")
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"quadratic_train: seed {seed} outside [0, 2^64)")
    if m * j >= 2**31:
        raise ValueError("quadratic_train: the particles have 2^31 or more elements")
    j0, j_total = (0, j) if shard is None else (shard.j0, shard.j_total)
    if j0 % 4:
        raise ValueError(f"quadratic_train: a shard starts at column {j0}, not a multiple of 4")
    dtype, device = u0.dtype, u0.device
    if num_steps == 0:
        empty = torch.zeros(0, dtype=dtype, device=device)
        return u0.clone(), empty, empty.bool(), torch.tensor(0, dtype=torch.int32)
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    a32, b32, e32, eb32 = f32(a), f32(b), f32(energy_matrix), f32(energy_bias)
    s32 = a32 if noise_factor is None else f32(noise_factor)  # unread when shared or noiseless
    items = phase(m, j, shared, zero_noise)
    with torch.cuda.device(device):
        u_a = u0.to(torch.float32).clone(memory_format=torch.contiguous_format)
        u_b = torch.empty_like(u_a)
        # the normals of even and odd steps; unread without noise
        eps = u_b if zero_noise else torch.empty((2, m, j), device=device)
        slabs = torch.empty(items.slab, dtype=torch.float32, device=device)
        arrived = torch.empty(items.tiles, dtype=torch.int32, device=device)
        # one energy partial a block in two sets; the grid never exceeds the items
        partials = torch.empty(2 * items.items, dtype=torch.float64, device=device)
        energies = torch.full((num_steps,), math.nan, dtype=torch.float32, device=device)
        lib = build.load("quadratic_train", _SIGNATURES)
        err = lib.plst_quadratic_train(
            a32.data_ptr(), e32.data_ptr(), s32.data_ptr(), b32.data_ptr(), eb32.data_ptr(),
            u_a.data_ptr(), u_b.data_ptr(), eps.data_ptr(), slabs.data_ptr(),
            arrived.data_ptr(), partials.data_ptr(), energies.data_ptr(), m, j, j0, j_total,
            int(num_steps), int(shared), items.slices, float(eta), float(patience),
            float(constant_share(e_const, j, shard)), int(seed),
            int(zero_noise), torch.cuda.current_stream().cuda_stream,
        )
        build.check(err, "quadratic_train kernel")
        quadratic_train.launches += 1
        energies = energies.to(dtype)
        recorded, steps_run = replay_early_stopper(energies, eta, patience)
    return u_a.to(dtype), energies, recorded, steps_run


quadratic_train.launches = 0
