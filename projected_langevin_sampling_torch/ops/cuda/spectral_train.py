"""B1: the whole-run spectral training kernel (``csrc/spectral_train.cu``)
and its plain version.

Replaces ``projected_langevin_sampling_tpu/ops/pallas/spectral_train.py``
(``spectral_train_fused``). For T steps, elementwise in the eigenbasis of the
drift:

    W' = decay * W + shift + noise_scale * eps
    energy_t = mean_j [0.5 sum_i sigma_i W'^2 - b . W'] + e_const

with the reference's early stopping in simulation time: the stop step's
update is applied and its energy written but not recorded, the particles
freeze after it and later energies are NaN.

Bound on the H100: operations (Philox, Box-Muller and a few FMAs per
element-step; W is read and written once per run). The kernel keeps the
particles in registers for all T steps, eight elements to a thread, and draws
its normals from a Philox4x32-10 written into the kernel and counted on
(group of four elements, step), through MUFU approximations of log2, sqrt,
sin and cos. :func:`mirror_normals` computes the same draws on the CPU in
fp64. Blocks cannot share a step's energy without a grid-wide sync,
so this wrapper runs two passes: the kernel writes one partial energy per
(block, step), the wrapper sums them, replays the early stopper and, if the
stop falls before the last step, reruns steps 0..stop from W0 on the same
counters. With infinite patience there is one pass. Unlike the TPU kernel
there is no resident-size limit: nothing needs the whole matrix in one place.

:func:`spectral_train` launches the kernel for CUDA tensors, in fp32 with a
cast at entry and exit as on the TPU, and runs :func:`spectral_train_reference`
only for tensors that lie on the CPU.

A ``shard`` (:class:`~projected_langevin_sampling_torch.utils.columns.ColumnShard`)
runs columns j0 .. j0 + J_loc of a J-column run: the kernel counts its
Philox groups on the run's flat index (row J + j0 + column), so a shard draws
exactly those columns of the unsharded run's normals (J_loc, j0 and J
multiples of 4), and the plain loop keeps those columns of the whole draw.
Its energies are the shard's share of the run's (``utils/columns.py``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from projected_langevin_sampling_torch.ops.cuda import build
from projected_langevin_sampling_torch.utils.columns import (
    ColumnShard,
    column_mean,
    column_normals,
    constant_share,
)
from projected_langevin_sampling_torch.utils.early_stopper import (
    NoiseChunks,
    replay_early_stopper,
    run_training,
    take,
)

THREADS = 256  # csrc/spectral_train.cu: threads per block
ELEMENTS_PER_THREAD = 8  # two groups of four, one Philox call each
# Steps per launch: bounds the (blocks, steps) partial-energy buffer, and lets
# the wrapper stop launching once the stopper has fired.
STEPS_PER_LAUNCH = 65536
# Operations per element-step, for the bound in PERF.md and chip_smoke.py:
# a quarter of a Philox4x32-10 call (10 rounds of 2 mul.hi, 2 mul.lo, 4 xor
# and 2 key adds = 100 integer ops, over 4 normals = 25), half a Box-Muller
# pair (2 int->float conversions and scalings, log, sqrt, sincos and 2
# multiplies over 2 normals ~ 6), the update (2 multiplies, 2 adds = 4) and
# the energy term (w*w, 2 FMAs and the running add counted as 2 each ~ 6).
OPS_PER_ELEMENT_STEP = 25 + 6 + 4 + 6

_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int,
    ctypes.c_void_p,
]

# Philox4x32-10 as csrc/philox.cuh has it (Random123's multipliers and Weyl
# key increments)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def num_blocks(total: int) -> int:
    """Blocks of the kernel's grid for ``total`` elements: THREADS threads of
    ELEMENTS_PER_THREAD consecutive elements each; the last block's tail is
    idle."""
    return -(-total // (THREADS * ELEMENTS_PER_THREAD))


def step_energies(partials: torch.Tensor, n: int, j: int, e_const: float) -> torch.Tensor:
    """The energies of a launch's first ``n`` steps from its (blocks, steps)
    partial buffer: the blocks' partials of a step summed, over J, plus the
    constant (for a column shard, J is the run's and ``e_const`` the
    shard's share of the constant)."""
    return partials[:, :n].sum(dim=0) / j + e_const


def philox4x32_10(ctr, key):
    """Philox4x32-10 on the CPU: ``ctr`` four arrays of 32-bit words (any
    integer dtype, broadcast together), ``key`` two; returns the four output
    words as uint64 arrays. Products are 32 x 32 -> 64 bits in uint64, which
    cannot overflow."""
    x, y, z, w = (np.asarray(c, dtype=np.uint64) & _MASK32 for c in ctr)
    k0, k1 = (int(k) & _MASK32 for k in key)
    m0, m1 = (np.uint64(m) for m in _PHILOX_M)
    for _ in range(10):
        p0, p1 = m0 * x, m1 * z
        x, y, z, w = ((p1 >> np.uint64(32)) ^ y ^ np.uint64(k0), p1 & np.uint64(_MASK32),
                      (p0 >> np.uint64(32)) ^ w ^ np.uint64(k1), p0 & np.uint64(_MASK32))
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return x, y, z, w


def uniform24(bits):
    """The kernel's uniform in (0, 1] from the top 24 bits of each word:
    ((bits >> 8) + 1) 2^-24, exact in fp64; all-ones bits give exactly 1."""
    return ((np.asarray(bits, dtype=np.uint64) >> np.uint64(8)) + np.uint64(1)) * 2.0**-24


def mirror_box_muller(seed: int, groups, step: int):
    """Box-Muller radii squared and angles of the kernel's draws, in fp64:
    for each group of four elements, Philox on the counter (group lo, group
    hi, step, 0) with the seed's key, and one pair from words (x, y) and one
    from (z, w): ``r2 = -2 ln u1``, ``theta = 2 pi u2 - pi``. Returns ``(r2,
    theta)``, each (len(groups), 2)."""
    g = np.asarray(groups, dtype=np.uint64)
    bits = philox4x32_10((g & np.uint64(_MASK32), g >> np.uint64(32), np.uint64(step), 0),
                         (seed & _MASK32, seed >> 32))
    u = [uniform24(b) for b in bits]
    r2 = np.stack([-2.0 * np.log(u[0]), -2.0 * np.log(u[2])], axis=1)
    theta = np.stack([2.0 * math.pi * u[1] - math.pi, 2.0 * math.pi * u[3] - math.pi], axis=1)
    return r2, theta


def mirror_normals(seed: int, groups, step: int) -> np.ndarray:
    """The kernel's four normals of each group at ``step``, in fp64,
    (len(groups), 4): element 4 g + k of the flattened (M, J) particles draws
    entry k of group g."""
    r2, theta = mirror_box_muller(seed, groups, step)
    r = np.sqrt(r2)
    z = np.empty((len(r), 4))
    z[:, 0::2], z[:, 1::2] = r * np.cos(theta), r * np.sin(theta)
    return z


def mirror_noise(seed: int, m: int, j: int, num_steps: int, j0: int = 0,
                 j_total: int | None = None) -> np.ndarray:
    """The kernel's draws of a whole run, in fp64, (num_steps, m, j): element
    4 g + k of each step's flattened (m, j_total) draws entry k of group g,
    and the run's columns j0 .. j0 + j are returned (all of them by
    default). Given to :func:`spectral_train_reference` as ``noise`` with
    ``q_in`` the identity, it replays a run of the kernel on ``seed`` with
    exact normals."""
    j_total = j if j_total is None else j_total
    flat = (np.arange(m)[:, None] * j_total + j0 + np.arange(j)[None, :]).reshape(-1)
    groups, inverse = np.unique(flat // 4, return_inverse=True)
    return np.stack([mirror_normals(seed, groups, t)[inverse, flat % 4].reshape(m, j)
                     for t in range(num_steps)])


def spectral_train_reference(
    w0: torch.Tensor,
    decay: torch.Tensor,
    shift: torch.Tensor,
    energy_sigma: torch.Tensor,
    b_rot: torch.Tensor,
    *,
    eta: float,
    patience: float,
    e_const,
    num_steps: int,
    noise_scale: float,
    zero_noise: bool = False,
    noise: torch.Tensor | None = None,
    q_in: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    shard: ColumnShard | None = None,
):
    """The plain PyTorch loop over T doing the kernel's math in the input's
    dtype, with the early-stopper carry.

    Noise per step: zeros with ``zero_noise``; else ``q_in^T @ noise[t]`` for
    injected noise ``noise`` (T, M, J) given in U coordinates (a shard's own
    columns), or a ``NoiseChunks`` of them; else standard normals from
    ``generator`` (a shard's columns of the whole draw). Returns ``(w,
    energies, recorded, steps_run)``.
    """
    dtype, device = w0.dtype, w0.device
    decay_c, shift_c, sigma_c = decay[:, None], shift[:, None], energy_sigma[:, None]
    if noise is not None:
        if q_in is None:
            raise ValueError("injected noise in U coordinates needs q_in")
        rotate = lambda z: q_in.T @ z  # noqa: E731  (T, M, J) in W coordinates
        noise = noise.map(rotate) if isinstance(noise, NoiseChunks) else rotate(noise)

    def step(t, state):
        (w,) = state
        if zero_noise:
            eps = torch.zeros_like(w)
        elif noise is not None:
            eps = take(noise, t)
        else:
            eps = column_normals(w.shape, generator, dtype, device, shard)
        w_new = decay_c * w + shift_c + noise_scale * eps
        energy_j = 0.5 * torch.sum(sigma_c * torch.square(w_new), dim=0) - b_rot @ w_new + e_const
        return (w_new,), column_mean(energy_j, shard)

    run = run_training(step, (w0,), num_steps, eta, patience, dtype, device, graph=False)
    return run.state[0], run.energies, run.recorded, run.steps_run


def _launch(w0, w_out, coeffs, partials, j, j0, j_total, step0, num_steps, noise_scale, seed,
            zero_noise):
    lib = build.load("spectral_train")
    fn = lib.plst_spectral_train
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(
        w0.data_ptr(), w_out.data_ptr(), *(c.data_ptr() for c in coeffs),
        partials.data_ptr(), partials.shape[1], w0.numel(), j, j0, j_total, partials.shape[0],
        step0, num_steps, float(noise_scale), seed, int(zero_noise), stream,
    )
    build.check(err, "spectral_train kernel")
    spectral_train.launches += 1


def _run_kernel(w0, coeffs, j, num_steps, noise_scale, seed, zero_noise, e_const,
                step_size=None, patience=None, shard=None):
    """Run ``num_steps`` steps in launches of at most STEPS_PER_LAUNCH.

    Returns ``(w, energies)``. With ``step_size``/``patience`` it stops
    launching once the replayed stopper has fired (the trace beyond is not
    needed; the caller reruns to the stop). A ``shard``'s energies are its
    share."""
    j0, j_total = (0, j) if shard is None else (shard.j0, shard.j_total)
    e_const = constant_share(e_const, j, shard)
    partials = torch.empty(
        (num_blocks(w0.numel()), min(num_steps, STEPS_PER_LAUNCH)), dtype=torch.float32,
        device=w0.device,
    )
    energies = torch.full((num_steps,), float("nan"), dtype=torch.float32, device=w0.device)
    w = w0
    for step0 in range(0, num_steps, STEPS_PER_LAUNCH):
        n = min(STEPS_PER_LAUNCH, num_steps - step0)
        w_next = torch.empty_like(w0)
        _launch(w, w_next, coeffs, partials, j, j0, j_total, step0, n, noise_scale, seed,
                zero_noise)
        energies[step0:step0 + n] = step_energies(partials, n, j_total, e_const)
        w = w_next
        if step_size is not None and step0 + n < num_steps:
            _, steps_run = replay_early_stopper(energies[: step0 + n], step_size, patience)
            if int(steps_run) < step0 + n:
                break
    return w, energies


def spectral_train(
    w0: torch.Tensor,
    decay: torch.Tensor,
    shift: torch.Tensor,
    energy_sigma: torch.Tensor,
    b_rot: torch.Tensor,
    *,
    eta: float,
    patience: float,
    e_const,
    num_steps: int,
    noise_scale: float,
    seed: int = 0,
    zero_noise: bool = False,
    noise: torch.Tensor | None = None,
    q_in: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    shard: ColumnShard | None = None,
):
    """Run ``num_steps`` spectral steps; returns ``(w, energies, recorded,
    steps_run)`` in ``w0``'s dtype.

    On CUDA tensors the kernel runs in fp32 with Philox noise keyed on
    ``seed``; injected ``noise`` is refused there, and ``q_in`` and
    ``generator`` serve only the plain loop. ``zero_noise`` switches the noise
    off for exact comparison with the plain version. ``shard``: the columns
    of a J-column run these particles are (module note). On CPU tensors the
    plain loop runs."""
    if w0.device.type == "cpu":
        return spectral_train_reference(
            w0, decay, shift, energy_sigma, b_rot, eta=eta, patience=patience,
            e_const=e_const, num_steps=num_steps, noise_scale=noise_scale,
            zero_noise=zero_noise, noise=noise, q_in=q_in, generator=generator, shard=shard,
        )
    if w0.device.type != "cuda":
        raise ValueError(f"spectral_train: particles on {w0.device}")
    if noise is not None:
        raise ValueError("spectral_train: the kernel draws its own Philox noise; "
                         "injected noise is for CPU tensors")
    if w0.ndim != 2:
        raise ValueError(f"spectral_train: particles of shape {tuple(w0.shape)}")
    m, j = w0.shape
    if shard is not None and (shard.j0 != 0 or shard.j_total != j) and (
        j % 4 or shard.j0 % 4 or shard.j_total % 4
    ):
        raise ValueError(
            f"spectral_train: a shard of {j} columns at {shard.j0} of {shard.j_total} draws "
            "whole Philox groups of four only if all three are multiples of 4"
        )
    coeffs = []
    for name, c in (("decay", decay), ("shift", shift), ("sigma", energy_sigma), ("b", b_rot)):
        if c.shape != (m,) or c.device != w0.device:
            raise ValueError(f"spectral_train: {name} of shape {tuple(c.shape)} on {c.device}")
        coeffs.append(c.to(torch.float32).contiguous())
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"spectral_train: seed {seed} outside [0, 2^64)")
    dtype = w0.dtype
    w32 = w0.to(torch.float32).contiguous()
    e_const = float(e_const)
    if num_steps == 0:
        empty = torch.zeros(0, dtype=dtype, device=w0.device)
        return w0.clone(), empty, empty.bool(), torch.tensor(0, dtype=torch.int32)
    with torch.cuda.device(w0.device):
        w, energies = _run_kernel(
            w32, coeffs, j, num_steps, noise_scale, int(seed), zero_noise, e_const,
            step_size=eta, patience=patience, shard=shard,
        )
        energies = energies.to(dtype)
        recorded, steps_run = replay_early_stopper(energies, eta, patience)
        stop = int(steps_run)
        if stop < num_steps:
            # the stop fell before the last step: rerun steps 0..stop from W0
            # on the same Philox counters; the stop step's update is applied
            w, _ = _run_kernel(w32, coeffs, j, stop, noise_scale, int(seed), zero_noise, e_const,
                               shard=shard)
            energies[stop:] = float("nan")
    return w.to(dtype), energies, recorded, steps_run


spectral_train.launches = 0
