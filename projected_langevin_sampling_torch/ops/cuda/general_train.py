"""B3: the whole-run general-cost trainer (``csrc/general_train.cu``) and its
plain version.

Replaces ``projected_langevin_sampling_tpu/ops/pallas/general_train.py``
(``general_train_fused``). On the orthonormal basis, for T steps:

    F  = P U + m0,   dc = d cost / d F (one of COST_KINDS, closed form),
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
products in 3xTF32 (``csrc/tc_product.cuh``), where the TPU kernel feeds
bf16 to its MXU; like B1 it has no resident-size limit.

Tiling (``ops/cuda/tc_product.py``): the forward product's (N, J) output in
64 x 128 tiles, one cost partial each; the update's (M_k, J) output in
64 x 128 tiles, one prior partial and one split-K arrival counter each,
over :func:`~projected_langevin_sampling_torch.ops.cuda.tc_product.split_k`
slices of N, whose partial tiles go to a slab of scratch.

:func:`general_train` launches the kernel for CUDA tensors, in fp32 with a
cast at entry and exit, and runs :func:`general_train_reference` only for
tensors that lie on the CPU. ``general_train.launches`` counts whole runs
(one C call queues the 3 T + 2 kernel launches of a run), and
``general_train.steps`` the steps those runs queue. Under the profiler a
call is the span ``pls.general_train`` (``utils/tracing.span``); on CUDA
tensors it holds ``.prepare`` (the casts, the row constants, the GH16
scalars and the buffers), ``.launch`` (the C call) and ``.stopper`` (the
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

import numpy as np
import torch

from projected_langevin_sampling_torch.ops.cuda import build, tc_product
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

# the order of the kernel's CostKind enum
COST_KINDS = (
    "gaussian",
    "bernoulli_sigmoid",
    "bernoulli_sigmoid_smoothed",
    "bernoulli_probit",
    "poisson_square",
    "student_t",
    "multimodal_identity",
)
DISCRETISATIONS = ("euler", "exponential", "preconditioned")
_SIGMOID_JITTER = 1e-10
# the physicists' 16-node Gauss-Hermite rule of the smoothed kind, scaled as
# the kernel applies it: E_z[g(f + s z)] = sum_q w_q / sqrt(pi) g(f + sqrt(2) x_q s)
GH16_NODES, GH16_WEIGHTS = np.polynomial.hermite.hermgauss(16)
_GH16_SCALED_NODES = math.sqrt(2.0) * GH16_NODES
_GH16_SCALED_WEIGHTS = GH16_WEIGHTS / math.sqrt(math.pi)

# fp32 operations per element of F for the bound in PERF.md and chip_smoke.py,
# besides the 4 M_k flops of the two products. A precise expf is counted as 8
# instructions, log1pf and erff as 20, a precise divide as 8; an add,
# multiply, compare or select as 1 and an FMA as 2. Estimates, not counts of
# the compiled code.
_EXP, _LOG, _DIV = 8, 20, 8
_SIGMOID = _EXP + 1 + _DIV
_SOFTPLUS = 3 + _EXP + _LOG
OPS_PER_ELEMENT = {
    "gaussian": 3 + _DIV + 4,
    "bernoulli_sigmoid": _SIGMOID + 4 + 2 * _LOG + 6 + 1,
    "bernoulli_sigmoid_smoothed": 2 + 16 * (2 + _SOFTPLUS + _SIGMOID + 4),
    "bernoulli_probit": 2 + _LOG + 6 + _EXP + 3 + 2 * _LOG + 6 + 3 + _DIV + 2,
    "poisson_square": 2 + _LOG + 4 + _DIV + 3,
    "student_t": 1 + 2 + _DIV + _LOG + 3 + 3 + _DIV,
    "multimodal_identity": 4 + _DIV + 2 * _LOG + _SOFTPLUS + _SIGMOID + 2 * _DIV + 8,
}
# per element of U: the update, the prior term and a quarter of a Philox call
# with half a Box-Muller pair (as B1's 25 + 6)
OPS_PER_UPDATE_ELEMENT = 8 + 4 + 31

_SIGNATURES = {"plst_general_train": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int,
    ctypes.c_void_p,
]}


def step_operations(kind: str, n: int, m_k: int, j: int) -> int:
    """fp32 operations of one training step (both products, the cost
    epilogue, the update), for the bound."""
    return 4 * n * m_k * j + OPS_PER_ELEMENT[kind] * n * j + OPS_PER_UPDATE_ELEMENT * m_k * j


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


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def cost_and_dc(kind: str, f: torch.Tensor, y: torch.Tensor, aux: torch.Tensor, params):
    """Elementwise cost and dc (N, J) of a cost kind, the kernel's closed
    forms (``_tile_cost_and_dc``) in the input's dtype; ``y`` and ``aux`` are
    (N, 1). The jitter floor is max(1e-10, dtype eps)."""
    p0, p1, p2 = params
    jit = max(_SIGMOID_JITTER, torch.finfo(f.dtype).eps)
    if kind == "gaussian":
        err = f - y
        return (0.5 / p0) * torch.square(err), err / p0
    if kind == "bernoulli_sigmoid":
        p = torch.clamp(torch.sigmoid(f), jit, 1.0 - jit)
        return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)), p - y
    if kind == "bernoulli_sigmoid_smoothed":
        cost, dc = -y * f, -y.expand_as(f)
        for node, weight in zip(_GH16_SCALED_NODES.tolist(), _GH16_SCALED_WEIGHTS.tolist()):
            zq = f + node * aux
            cost = cost + weight * _softplus(zq)
            dc = dc + weight * torch.sigmoid(zq)
        return cost, dc
    if kind == "bernoulli_probit":
        cdf = 0.5 * (1.0 + torch.erf(f * (0.5**0.5)))
        in_range = (cdf > jit) & (cdf < 1.0 - jit)
        p = torch.clamp(cdf, jit, 1.0 - jit)
        pdf = torch.exp(-0.5 * torch.square(f)) * (1.0 / math.sqrt(2.0 * math.pi))
        cost = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        dc = torch.where(in_range, pdf * (p - y) / (p * (1.0 - p)), torch.zeros_like(f))
        return cost, dc
    if kind == "poisson_square":
        return -2.0 * y * torch.log(torch.abs(f)) + torch.square(f), -2.0 * y / f + 2.0 * f
    if kind == "student_t":
        err = f - y
        denom = p0 * (p1 * p1)
        cost = 0.5 * (p0 + 1.0) * torch.log1p(torch.square(err) / denom)
        return cost, (p0 + 1.0) * err / (denom + torch.square(err))
    if kind == "multimodal_identity":
        sigma2 = p0 * p0
        err = y - f
        b = math.log(p2) - math.log1p(-p2)
        delta = -(p1 * err + 0.5 * p1 * p1) / sigma2
        log_norm = 0.5 * math.log(2.0 * math.pi * sigma2)
        cost = 0.5 * torch.square(err) / sigma2 + log_norm - math.log1p(-p2) - _softplus(b + delta)
        return cost, -(err + torch.sigmoid(b + delta) * p1) / sigma2
    raise ValueError(f"Unknown cost kind {kind!r}")


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
        cost, dc = cost_and_dc(kind, product(p, u) + mean_shift, y_col, aux_col, params)
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
        if kind not in COST_KINDS:
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
                [*params, float(mean_shift), *_GH16_SCALED_NODES, *_GH16_SCALED_WEIGHTS],
                dtype=torch.float32,
            )
            upd = tc_product.split_k(m_k, j, n)  # a prior partial and a counter per tile
            with torch.cuda.device(device):
                u_a = u0.to(torch.float32).clone(memory_format=torch.contiguous_format)
                u_b = torch.empty_like(u_a)
                dc = torch.empty((n, j), dtype=torch.float32, device=device)
                cost_partials = torch.empty(tc_product.tiles(n, j), dtype=torch.float64,
                                            device=device)
                prior_partials = torch.empty(upd.tiles, dtype=torch.float64, device=device)
                slabs = torch.empty(max(upd.slab, 1), dtype=torch.float32, device=device)
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
                energies.data_ptr(), state.data_ptr(), n, m_k, j, j0, j_total, int(num_steps),
                COST_KINDS.index(kind), DISCRETISATIONS.index(discretisation), upd.slices,
                host_params.data_ptr(), float(eta), float(patience), int(seed), int(zero_noise),
                torch.cuda.current_stream().cuda_stream,
            )
        build.check(err, "general_train kernel")
        general_train.launches += 1
        general_train.steps += int(num_steps)
        u = u_a if num_steps % 2 == 0 else u_b
        energies = energies.to(dtype)
        with span("pls.general_train.stopper"), torch.cuda.device(device):
            recorded, steps_run = replay_early_stopper(energies, eta, patience)
        return u.to(dtype), energies, recorded, steps_run


general_train.launches = 0
general_train.steps = 0
