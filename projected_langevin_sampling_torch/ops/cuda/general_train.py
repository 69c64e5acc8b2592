"""B3: the whole-run general-cost trainer (``csrc/general_train.cu``) and its
plain version.

Replaces ``projected_langevin_sampling_tpu/ops/pallas/general_train.py``
(``general_train_fused``). On the orthonormal basis, for T steps:

    F  = P U + m0,   dc = d cost / d F (a kind of ``cost_forms.py``, closed form),
    G  = P^T dc
    euler:  U' = U - eta (G + U / lambda) + sqrt(2 eta) eps
    split:  U' = x - (1 - dec) x + nscale eps,  x = U - eta ds G

with the energy of each update, mean_j(cost_j + 0.5 sum_i U^2 / lambda_i),
and the reference's early stopping: the stop step's update is applied and
its energy written but not recorded, the particles freeze after it and later
energies are NaN. The split schemes' row constants are
:func:`split_row_constants`, whose decay is its complement 1 - dec, which fp32
holds to its own precision where dec itself, rounded, would bias every step
alike.

Bound on the H100: operations, 4 N M_k J flops of two fp32 products per step
(three TF32 products each on the tensor cores) plus the cost kind's special
functions on the CUDA cores (see the source note). The kernel queues three
launches per step on the current stream (forward product with the cost
epilogue, a one-block stopper, the transposed product with the update) and
never synchronises inside the run; the stopper state lives on the card, so
there is one pass whatever the patience. Operands and sums are fp32, the
products in 3xTF32 on ``wgmma`` (``csrc/wgmma_tma.cuh``), where the TPU
kernel feeds bf16 to its MXU; like B1 it has no resident-size limit.

Tiling. The forward sweep (F = P U and the cost epilogue) is one persistent
block an SM (:func:`forward_plan`): its (N, J) output in 64 x 128 tiles,
one cost partial each, which block b takes in the fixed order b, b + grid,
... (:func:`forward_schedule`); in each block a warpgroup multiplies on
``wgmma``, its thread 0 keeping TMA loads in flight, while twelve warps run
the cost epilogue of the tile before. ``wgmma`` reads both operands K-major
from shared memory in TF32, so the forward reads its operands split once
(:func:`split_operands`): P's TF32 halves (2, N, K) and U^T's (2, J, K), K =
M_k padded with zero columns to a multiple of ``FORWARD_TILE_K``; the run's
first launch writes both, and every update writes U'^T's halves beside U'.
The smoothed kind's division and ``log1pf`` run as branch-free twins that
give the library's bits on every input they take (:func:`check_math`).
The update computes the transpose G^T = dc^T P, also persistent on
``wgmma`` (:func:`update_plan`, :func:`update_schedule`): its (J, M_k) output
in 128 x 128 tiles, one split-K arrival counter each, over slices of N whose
partial tiles go to a slab of scratch; once a tile's units have all arrived
(they run in one wave, one block an SM), each sums one band of the tile's
rows in slice order and updates it, one prior partial a unit. ``wgmma``
reads TF32 B only K-major, so B is P^T's TF32 halves (2, K, depth), depth =
N padded to a multiple of ``UPDATE_TILE_K``, split once a run beside the
forward's operands (:func:`split_update_operand`); A is dc^T, read from dc's
fp32 tile in shared memory and split in registers (:func:`update_product` is
the plain product of these operands). dc's rows lie :func:`dc_pitch` floats
apart, J rounded up to 4, the 16-byte stride TMA needs.

:func:`general_train` launches the kernel for CUDA tensors, in fp32 with a
cast at entry and exit, and runs :func:`general_train_reference` only for
tensors that lie on the CPU. ``general_train.launches`` counts whole runs
(one C call queues the 3 T + 2 kernel launches of a run),
``general_train.steps`` the steps those runs queue, and
``general_train.update_wgmma_steps`` those whose update ran on the ``wgmma``
update (all of them, on the card). Under the profiler a call is the span
``pls.general_train`` (``utils/tracing.span``); on CUDA tensors it holds
``.prepare`` (the casts, the row constants, the GH16 scalars and the
buffers, the split operands' 2 (N + J) K + 2 K depth floats among them: 45
MB at the headline), ``.launch`` (the C call) and ``.stopper`` (the
stopper's replay, which reads the energies back).

A ``shard`` (:class:`~projected_langevin_sampling_torch.utils.columns.ColumnShard`)
runs columns j0 .. j0 + J_loc of a J-column run: the kernel counts its
Philox groups on the run's column (j0 a multiple of 4) and the plain loop
keeps those columns of the whole draw, so a shard draws exactly the
unsharded run's normals of its columns; its energies are its share, sums
over J. The kernel's own stopper sees only the shard's share, so a shard runs
with infinite patience and ``parallel/auto.py`` takes the run's stop.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from projected_langevin_sampling_torch.ops.cuda import build, cost_forms, tc_product
from projected_langevin_sampling_torch.utils.columns import (
    ColumnShard,
    column_mean,
    column_normals,
)
from projected_langevin_sampling_torch.utils.early_stopper import (
    replay_early_stopper,
    run_training,
    take,
)
from projected_langevin_sampling_torch.utils.tracing import span

DISCRETISATIONS = ("euler", "exponential", "preconditioned")
# the Bernoulli kinds' jitter, the one the kernel instantiates (csrc/general_train.cu
# JITTER): the library default, the only one ``closed_forms.py`` gives B3
JITTER = 1e-10
# fp32 operations per element of U: the update, the prior term and a quarter
# of a Philox call with half a Box-Muller pair (as B1's 25 + 6)
OPS_PER_UPDATE_ELEMENT = 8 + 4 + 31

_SIGNATURES = {
    "plst_general_train": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "plst_general_split_operands": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "plst_general_check_math": [ctypes.c_void_p, ctypes.c_void_p],
}

# the forward sweep's stage depth (csrc/general_train.cu fwd::BK): one 128-byte
# swizzle row of fp32; M_k is padded with zero columns to a multiple of it
FORWARD_TILE_K = 32
# the SMs of an H100 SXM: the forward's persistent grid where no card is asked
H100_SMS = 132


class ForwardPlan(NamedTuple):
    tiles: int  # 64 x 128 tiles of the (N, J) output: cost partials
    col_tiles: int  # tiles across J
    k: int  # M_k padded to a multiple of FORWARD_TILE_K: the split operands' depth
    grid: int  # persistent blocks, one an SM, at most one a tile


def forward_plan(n: int, m_k: int, j: int, sms: int = H100_SMS) -> ForwardPlan:
    """The forward sweep's tiles, padded depth and grid on a card of ``sms``
    SMs."""
    tiles = tc_product.tiles(n, j)
    k = -(-m_k // FORWARD_TILE_K) * FORWARD_TILE_K
    return ForwardPlan(tiles, -(-j // tc_product.TILE_N), k, min(sms, tiles))


def forward_schedule(plan: ForwardPlan) -> list[list[tuple[int, int]]]:
    """The (row tile, column tile) pairs each block of the forward sweep runs,
    in its order: block b takes tiles b, b + grid, ..., tile t being row tile
    t // column tiles and column tile t % column tiles, whose cost partial is
    entry t (the kernel's order)."""
    return [[divmod(t, plan.col_tiles) for t in range(b, plan.tiles, plan.grid)]
            for b in range(plan.grid)]


# the update's tiles (csrc/general_train.cu upd::TJ, TM, BK): 128 particles by
# 128 rows of M_k, stages 32 deep along N
UPDATE_TILE_J, UPDATE_TILE_M, UPDATE_TILE_K = 128, 128, 32
# a slice walks at least this many stages, and a tile takes at most this many
# slices: each slice adds a partial tile that the tile's units read back
UPDATE_MIN_SLICE_STAGES, UPDATE_MAX_SLICES = 4, 8


class UpdatePlan(NamedTuple):
    tiles: int  # 128 x 128 tiles of the (J, M_k) output G^T: arrival counters
    col_tiles: int  # tiles across M_k
    slices: int  # slices of the depth N a tile is cut into: a prior partial each
    depth: int  # N padded to a multiple of UPDATE_TILE_K: P^T's split rows
    grid: int  # persistent blocks, one an SM, at most one a work unit


def update_plan(n: int, m_k: int, j: int, sms: int = H100_SMS) -> UpdatePlan:
    """The update's tiles, slices of N, padded depth and grid on a card of
    ``sms`` SMs: as many slices as fill the SMs with (tile, slice) units, at
    most ``UPDATE_MAX_SLICES`` and none shallower than
    ``UPDATE_MIN_SLICE_STAGES`` stages unless N is, and none empty. A tile is
    cut only where all units fit one block an SM at once, since a cut tile's
    units wait for each other."""
    col_tiles = -(-m_k // UPDATE_TILE_M)
    tiles = -(-j // UPDATE_TILE_J) * col_tiles
    stages = -(-n // UPDATE_TILE_K)
    wanted = max(1, min(sms // tiles, UPDATE_MAX_SLICES, stages // UPDATE_MIN_SLICE_STAGES))
    slices = -(-stages // -(-stages // wanted))
    return UpdatePlan(tiles, col_tiles, slices, stages * UPDATE_TILE_K,
                      min(sms, tiles * slices))


def update_schedule(plan: UpdatePlan) -> list[list[tuple[int, int, int, int, int]]]:
    """The work units each block of the update runs, in its order: block b
    takes units b, b + grid, ..., unit u being slice u // tiles of tile u %
    tiles, tile t being particle tile t // column tiles and M_k tile t %
    column tiles, and slice s stages [s per, (s + 1) per) of N, per =
    ceil(stages / slices) (the kernel's order). Entries are (particle tile,
    M_k tile, slice, first stage, end stage)."""
    stages = plan.depth // UPDATE_TILE_K
    per = -(-stages // plan.slices)
    units = plan.tiles * plan.slices
    return [[(*divmod(u % plan.tiles, plan.col_tiles), u // plan.tiles,
              (u // plan.tiles) * per, min(stages, (u // plan.tiles + 1) * per))
             for u in range(b, units, plan.grid)]
            for b in range(plan.grid)]


def dc_pitch(j: int) -> int:
    """Floats between rows of the (N, J) dc buffer: J rounded up to 4, the
    16-byte stride of the update's TMA map."""
    return -(-j // 4) * 4


def split_operands_reference(p: torch.Tensor, u: torch.Tensor, k: int):
    """The forward's operands in plain PyTorch: ``(p_split, ut_split)``, the
    TF32 halves (:func:`tc_product.tf32_split`) of P (N, M_k) as (2, N, k) and
    of U^T, U (M_k, J), as (2, J, k), K-major, zero in columns M_k .. k - 1."""
    def halves(x):
        out = torch.zeros((2, x.shape[0], k), dtype=torch.float32, device=x.device)
        out[0, :, :x.shape[1]], out[1, :, :x.shape[1]] = tc_product.tf32_split(x)
        return out

    return halves(p.to(torch.float32)), halves(u.to(torch.float32).T)


def split_operands(p: torch.Tensor, u: torch.Tensor, k: int):
    """:func:`split_operands_reference` on the card: the kernel's prologue
    (``init_run_kernel``) alone, for fp32 CUDA tensors; the plain version for
    CPU tensors."""
    if p.device.type == "cpu":
        return split_operands_reference(p, u, k)
    (n, m_k), j = p.shape, u.shape[1]
    if p.dtype != torch.float32 or u.dtype != torch.float32 or u.shape[0] != m_k:
        raise ValueError(f"split_operands: P {tuple(p.shape)} {p.dtype}, U {tuple(u.shape)} "
                         f"{u.dtype}")
    p, u = p.contiguous(), u.contiguous()
    with torch.cuda.device(p.device):
        p_split = torch.empty((2, n, k), dtype=torch.float32, device=p.device)
        ut_split = torch.empty((2, j, k), dtype=torch.float32, device=p.device)
        err = build.load("general_train", _SIGNATURES).plst_general_split_operands(
            p.data_ptr(), u.data_ptr(), p_split.data_ptr(), ut_split.data_ptr(), None, n, m_k,
            k, j, update_plan(n, m_k, j).depth, torch.cuda.current_stream().cuda_stream)
    build.check(err, "general_train split_operands")
    return p_split, ut_split


def split_update_operand_reference(p: torch.Tensor, k: int, depth: int) -> torch.Tensor:
    """The update's B operand in plain PyTorch: the TF32 halves of P^T, P (N,
    M_k), as (2, k, depth), K-major along N, zero in rows M_k .. k - 1 and
    columns N .. depth - 1."""
    n, m_k = p.shape
    out = torch.zeros((2, k, depth), dtype=torch.float32, device=p.device)
    out[0, :m_k, :n], out[1, :m_k, :n] = tc_product.tf32_split(p.to(torch.float32).T.contiguous())
    return out


def split_update_operand(p: torch.Tensor, k: int, depth: int) -> torch.Tensor:
    """:func:`split_update_operand_reference` on the card (``init_run_kernel``
    writing P^T's halves alone), for an fp32 CUDA P; the plain version for a
    CPU P."""
    if p.device.type == "cpu":
        return split_update_operand_reference(p, k, depth)
    n, m_k = p.shape
    if p.dtype != torch.float32:
        raise ValueError(f"split_update_operand: P {tuple(p.shape)} {p.dtype}")
    p = p.contiguous()
    with torch.cuda.device(p.device):
        pt_split = torch.empty((2, k, depth), dtype=torch.float32, device=p.device)
        err = build.load("general_train", _SIGNATURES).plst_general_split_operands(
            p.data_ptr(), None, None, None, pt_split.data_ptr(), n, m_k, k, 1, depth,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "general_train split_update_operand")
    return pt_split


def check_math(device="cuda") -> tuple[int, int]:
    """The card's check of the smoothed kind's branch-free reciprocal and
    log1p against the library's division and ``log1pf``, over every float
    each takes (d in [1, 2^126); finite a >= 0): the counts of results that
    differ in a bit, ``(0, 0)`` where they are the library's."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(counts.device):
        err = build.load("general_train", _SIGNATURES).plst_general_check_math(
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "general_train check_math")
    return tuple(int(v) for v in counts.tolist())


def forward_product(p_split: torch.Tensor, ut_split: torch.Tensor) -> torch.Tensor:
    """The forward's 3xTF32 product P U from its split operands, in fp32:
    ``(p_lo u_hi + p_hi u_lo) + p_hi u_hi`` over the padded depth, the three
    products ``tc_product.tf32x3_matmul`` sums (the kernel adds them an
    8-deep step at a time)."""
    (p_hi, p_lo), (u_hi, u_lo) = p_split, ut_split
    return (p_lo @ u_hi.T + p_hi @ u_lo.T) + p_hi @ u_hi.T


def update_product(dc: torch.Tensor, pt_split: torch.Tensor, m_k: int) -> torch.Tensor:
    """The update's 3xTF32 product G = P^T dc (M_k, J) from its operands, in
    fp32: dc (N, J) split into TF32 halves as the kernel splits its fragments,
    and P^T's split halves; G^T = (a_lo b_hi + a_hi b_lo) + a_hi b_hi with A =
    dc^T and B = P^T over the padded depth (its columns past N are zero)."""
    n = dc.shape[0]
    a_hi, a_lo = tc_product.tf32_split(dc.to(torch.float32).T.contiguous())
    b_hi, b_lo = pt_split[0, :m_k, :n], pt_split[1, :m_k, :n]
    return ((a_lo @ b_hi.T + a_hi @ b_lo.T) + a_hi @ b_hi.T).T


def step_operations(kind: str, n: int, m_k: int, j: int) -> int:
    """fp32 operations of one training step (both products, the cost
    epilogue, the update), for the bound."""
    return (4 * n * m_k * j + cost_forms.KINDS[kind].ops * n * j
            + OPS_PER_UPDATE_ELEMENT * m_k * j)


def split_row_constants(eigenvalues: torch.Tensor, eta: float, discretisation: str):
    """``(inv_lam, one_minus_dec, ds, nscale)``, each (M_k,) in the
    eigenvalues' dtype; the split update is U' = x - one_minus_dec x +
    nscale eps with x = U - eta ds P^T dc.

    exponential: the prior drift and its noise integrated exactly,
      dec = exp(-eta / lam), ds = 1, nscale = sqrt(lam (1 - exp(-2 eta / lam)));
    preconditioned: Lambda-preconditioned Langevin with the exact OU prior step,
      dec = exp(-eta), ds = lam, nscale = sqrt(lam (1 - exp(-2 eta)));
    euler: dec = ds = 1, nscale = 0 (unused).

    The decay enters as its complement 1 - dec, from expm1: in fp32 a rounded
    dec = e^-eta is off by up to 2^-25 relative, and the update compounds the
    same error at every step (after T steps the particles' start is off by up
    to T 2^-25 of itself, 2e-5 at T = 2000, eta = 1e-3, and the stationary
    variance by up to 2^-25 / eta), where the complement carries its rounding
    on a number of size eta."""
    lam = eigenvalues
    inv_lam = 1.0 / lam
    if discretisation == "exponential":
        one_minus_dec = -torch.expm1(-eta / lam)
        ds = torch.ones_like(lam)
        nscale = torch.sqrt(lam * -torch.expm1(-2.0 * eta / lam))
    elif discretisation == "preconditioned":
        one_minus_dec = torch.full_like(lam, -math.expm1(-eta))
        ds = lam
        nscale = torch.sqrt(lam * -math.expm1(-2.0 * eta))
    elif discretisation == "euler":
        one_minus_dec, nscale = torch.zeros_like(lam), torch.zeros_like(lam)
        ds = torch.ones_like(lam)
    else:
        raise ValueError(f"Unknown discretisation {discretisation!r}")
    return inv_lam, one_minus_dec, ds, nscale


def general_train_reference(
    p: torch.Tensor,
    u0: torch.Tensor,
    y: torch.Tensor,
    eigenvalues: torch.Tensor,
    kind: str,
    *,
    eta: float,
    patience: float,
    num_steps: int,
    params=(0.0, 0.0, 0.0),
    mean_shift: float = 0.0,
    aux: torch.Tensor | None = None,
    discretisation: str = "euler",
    zero_noise: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    product=torch.matmul,
    shard: ColumnShard | None = None,
):
    """The plain PyTorch loop over T doing the kernel's math in the input's
    dtype, with the early-stopper carry.

    Noise per step: zeros with ``zero_noise``; else ``noise[t]`` for injected
    standard normals ``noise`` (T, M_k, J) (a shard's own columns); else
    normals from ``generator`` (a shard's columns of the whole draw).
    ``product`` computes P U and P^T dc (the tests put the emulation of the
    kernel's 3xTF32 product there). Returns ``(u, energies, recorded,
    steps_run)``."""
    dtype, device = u0.dtype, u0.device
    inv_lam, one_minus_dec, ds, nscale = (
        c[:, None] for c in split_row_constants(eigenvalues, eta, discretisation)
    )
    root2eta = math.sqrt(2.0 * eta)
    y_col = y[:, None]
    aux_col = torch.zeros_like(y_col) if aux is None else aux[:, None]

    def sweep(u):
        f = product(p, u) + mean_shift
        cost, dc = cost_forms.cost_and_dc(kind, f, y_col, aux_col, params)
        return torch.sum(cost, dim=0), dc

    def step(t, state):
        # carries dc: the sweep of this step's energy gives the next drift
        u, dc = state
        g = product(p.T, dc)
        if discretisation == "euler":
            u_new = u - eta * (g + u * inv_lam)
            scale = root2eta
        else:
            x = u - eta * (ds * g)
            u_new = x - one_minus_dec * x
            scale = nscale
        if not zero_noise:
            eps = take(noise, t) if noise is not None else column_normals(
                u.shape, generator, dtype, device, shard
            )
            u_new = u_new + scale * eps
        cost_j, dc_new = sweep(u_new)
        prior_j = 0.5 * torch.sum(torch.square(u_new) * inv_lam, dim=0)
        return (u_new, dc_new), column_mean(cost_j + prior_j, shard)

    run = run_training(step, (u0, sweep(u0)[1]), num_steps, eta, patience, dtype, device,
                       graph=False)
    return run.state[0], run.energies, run.recorded, run.steps_run


def general_train(
    p: torch.Tensor,
    u0: torch.Tensor,
    y: torch.Tensor,
    eigenvalues: torch.Tensor,
    kind: str,
    *,
    eta: float,
    patience: float,
    num_steps: int,
    params=(0.0, 0.0, 0.0),
    mean_shift: float = 0.0,
    aux: torch.Tensor | None = None,
    discretisation: str = "euler",
    seed: int = 0,
    zero_noise: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    shard: ColumnShard | None = None,
):
    """Run ``num_steps`` general-cost steps; returns ``(u, energies, recorded,
    steps_run)`` in ``u0``'s dtype.

    On CUDA tensors the kernel runs in fp32 with Philox noise keyed on
    ``seed``; injected ``noise`` is refused there and ``generator`` serves only
    the plain loop. ``zero_noise`` switches the noise off for exact comparison
    with the plain version. ``shard``: the columns of a J-column run these
    particles are (module note). On CPU tensors the plain loop runs."""
    with span("pls.general_train"):
        if kind not in cost_forms.COST_KINDS:
            raise ValueError(f"general_train: unknown cost kind {kind!r}")
        if discretisation not in DISCRETISATIONS:
            raise ValueError(f"general_train: unknown discretisation {discretisation!r}")
        params = tuple(float(v) for v in params)
        if u0.device.type == "cpu":
            return general_train_reference(
                p, u0, y, eigenvalues, kind, eta=eta, patience=patience, num_steps=num_steps,
                params=params, mean_shift=mean_shift, aux=aux, discretisation=discretisation,
                zero_noise=zero_noise, noise=noise, generator=generator, shard=shard,
            )
        if u0.device.type != "cuda":
            raise ValueError(f"general_train: particles on {u0.device}")
        if noise is not None:
            raise ValueError("general_train: the kernel draws its own Philox noise; "
                             "injected noise is for CPU tensors")
        if cost_forms.KINDS[kind].jitter and params[0] != JITTER:
            raise ValueError(f"general_train: the kernel's jitter is {JITTER}, not {params[0]}")
        if p.ndim != 2 or u0.ndim != 2 or u0.shape[0] != p.shape[1]:
            raise ValueError(f"general_train: P {tuple(p.shape)} and U0 {tuple(u0.shape)}")
        n, m_k = p.shape
        j = u0.shape[1]
        for name, t, shape in (("P", p, (n, m_k)), ("y", y, (n,)),
                               ("eigenvalues", eigenvalues, (m_k,)), ("aux", aux, (n,))):
            if t is not None and (t.shape != shape or t.device != u0.device):
                raise ValueError(f"general_train: {name} of shape {tuple(t.shape)} on {t.device}")
        if not 0 <= int(seed) < 2**64:
            raise ValueError(f"general_train: seed {seed} outside [0, 2^64)")
        if max(n * j, m_k * j, n * m_k) >= 2**31:
            raise ValueError("general_train: a matrix has 2^31 or more elements")
        j0, j_total = (0, j) if shard is None else (shard.j0, shard.j_total)
        if j0 % 4:
            raise ValueError(f"general_train: a shard starts at column {j0}, not a multiple of 4")
        dtype, device = u0.dtype, u0.device
        if num_steps == 0:
            empty = torch.zeros(0, dtype=dtype, device=device)
            return u0.clone(), empty, empty.bool(), torch.tensor(0, dtype=torch.int32)
        with span("pls.general_train.prepare"):
            f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
            # in the input's dtype, as the plain version computes them
            row_constants = [f32(c) for c in split_row_constants(eigenvalues, eta, discretisation)]
            p32, y32 = f32(p), f32(y)
            aux32 = torch.zeros_like(y32) if aux is None else f32(aux)
            # the kernel's 4 + 2 x 16 scalars, read on the host by the C entry point
            host_params = torch.tensor(
                [*params, float(mean_shift), *cost_forms.GH16_SCALED_NODES,
                 *cost_forms.GH16_SCALED_WEIGHTS],
                dtype=torch.float32,
            )
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            fwd = forward_plan(n, m_k, j, sms)  # a cost partial per tile, the split operands
            upd = update_plan(n, m_k, j, sms)  # a counter a tile, a prior partial a unit
            slab = upd.slices * upd.tiles * UPDATE_TILE_J * UPDATE_TILE_M if upd.slices > 1 else 0
            with torch.cuda.device(device):
                u_a = u0.to(torch.float32).clone(memory_format=torch.contiguous_format)
                u_b = torch.empty_like(u_a)
                dc = torch.empty((n, dc_pitch(j)), dtype=torch.float32, device=device)
                cost_partials = torch.empty(fwd.tiles, dtype=torch.float64, device=device)
                # written by the kernel: the run's first launch and every update
                p_split = torch.empty((2, n, fwd.k), dtype=torch.float32, device=device)
                ut_split = torch.empty((2, j, fwd.k), dtype=torch.float32, device=device)
                pt_split = torch.empty((2, fwd.k, upd.depth), dtype=torch.float32, device=device)
                prior_partials = torch.empty(upd.tiles * upd.slices, dtype=torch.float64,
                                             device=device)
                slabs = torch.empty(max(slab, 1), dtype=torch.float32, device=device)
                counters = torch.empty(upd.tiles, dtype=torch.int32, device=device)
                energies = torch.full((num_steps,), math.nan, dtype=torch.float32, device=device)
                state = torch.empty(4, dtype=torch.int32, device=device)
            library = build.load("general_train", _SIGNATURES)
        with span("pls.general_train.launch"), torch.cuda.device(device):
            err = library.plst_general_train(
                p32.data_ptr(), y32.data_ptr(), aux32.data_ptr(),
                *(c.data_ptr() for c in row_constants),
                u_a.data_ptr(), u_b.data_ptr(), dc.data_ptr(), cost_partials.data_ptr(),
                prior_partials.data_ptr(), slabs.data_ptr(), counters.data_ptr(),
                energies.data_ptr(), state.data_ptr(), p_split.data_ptr(), ut_split.data_ptr(),
                pt_split.data_ptr(), n, m_k, fwd.k, j, j0, j_total, int(num_steps),
                cost_forms.COST_KINDS.index(kind), DISCRETISATIONS.index(discretisation),
                dc.shape[1], upd.depth, upd.slices, fwd.grid, upd.grid,
                host_params.data_ptr(), float(eta), float(patience), int(seed), int(zero_noise),
                torch.cuda.current_stream().cuda_stream,
            )
        build.check(err, "general_train kernel")
        general_train.launches += 1
        general_train.steps += int(num_steps)
        general_train.update_wgmma_steps += int(num_steps)
        u = u_a if num_steps % 2 == 0 else u_b
        energies = energies.to(dtype)
        with span("pls.general_train.stopper"), torch.cuda.device(device):
            recorded, steps_run = replay_early_stopper(energies, eta, patience)
        return u.to(dtype), energies, recorded, steps_run


general_train.launches = 0
general_train.steps = 0
general_train.update_wgmma_steps = 0
