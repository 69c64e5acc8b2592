"""B5: one fused Langevin update of the general tier (``csrc/fused_update.cu``)
and its plain version.

Replaces ``projected_langevin_sampling_tpu/ops/pallas/fused_update.py``
(``fused_langevin_update`` and ``dc_fn_for_cost``):

    F  = P U + m0,   dc = d cost / d F (one of :data:`KINDS`, ``cost_forms.py``)
    U' = U - eta (D^T dc + prior(U)) + sqrt(2 eta) noise

with a diagonal prior (M,) multiplying U (the orthonormal basis: 1 / lambda,
D = P) or a matrix prior (M, M) applied to U (the inducing-point basis:
M K^{-1}, D = k(X, Z)). The noise is precomputed (S z for the inducing-point
basis), as in the JAX package. ``mean_shift`` = 0 is exactly the TPU
kernel's function; ``training.langevin_steps`` passes the basis's mean
constant.

Bound on the H100: operations, 4 N M J flops of the two N products (plus
2 M^2 J for a matrix prior), three TF32 products each on the tensor cores
(3xTF32, ``csrc/tc_product.cuh``: fp32-level error), and the dc closed form
per element of F. The kernel is two launches on the current stream (F with
the dc epilogue into an (N, J) scratch buffer, then D^T dc with the update),
no atomics on values; D is read in whichever of the layouts (N, M) or its
transpose (M, N) it is stored in.

Tiling (``ops/cuda/tc_product.py``): both products in 64 x 128 output
tiles; the update's (M, J) output over
:func:`~projected_langevin_sampling_torch.ops.cuda.tc_product.split_k` slices
of its depth (N, then M for a matrix prior, N rounded up to a stage), one
split-K arrival counter per tile and a slab of partial tiles as scratch.

:func:`fused_update` launches the kernel for CUDA tensors, in fp32 with a
cast at entry and exit, and runs :func:`fused_update_reference` only for
tensors that lie on the CPU. ``fused_update.launches`` counts launched
updates. Which costs take which kind is ``closed_forms.py``'s rule.

:func:`fused_drift` is the kernel's partial mode, for a step whose N rows
are spread over the data ranks of a mesh (``parallel/sharded.py``): the same
two launches return D^T dc over the given rows, (M, J), with no prior, noise
or eta; the caller sums it over the ranks and finishes the step with
:func:`apply_drift`. ``fused_drift.launches`` counts its launches and
:func:`fused_drift_reference` is its plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from projected_langevin_sampling_torch.ops.cuda import build, cost_forms, tc_product

# the kinds the kernel instantiates: those it has a dc count for
KINDS = tuple(kind for kind, facts in cost_forms.KINDS.items() if facts.dc_ops is not None)
# fp32 operations per element of U: the prior term, eta, the noise and the update
OPS_PER_UPDATE_ELEMENT = 6

_SIGNATURES = {"plst_fused_update": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                                    + [ctypes.c_float] * 4 + [ctypes.c_void_p]}


def step_operations(kind: str, n: int, m: int, j: int, prior_is_diag: bool) -> int:
    """fp32 operations of one update, for the bound."""
    prior = 0 if prior_is_diag else 2 * m * m * j
    return (4 * n * m * j + prior + cost_forms.KINDS[kind].dc_ops * n * j
            + OPS_PER_UPDATE_ELEMENT * m * j)


def _check_kind(kind: str, what: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"{what}: no instance of the cost kind {kind!r} (it has {KINDS})")


def fused_drift_reference(
    p: torch.Tensor,
    d: torch.Tensor,
    y: torch.Tensor,
    u: torch.Tensor,
    kind: str,
    *,
    params=(0.0, 0.0),
    mean_shift: float = 0.0,
) -> torch.Tensor:
    """The partial mode's D^T dc (M, J) in plain PyTorch, in the input's dtype."""
    p0, p1 = params
    f = p @ u + mean_shift
    return d.T @ cost_forms.cost_and_dc(kind, f, y[:, None], None, (p0, p1, 0.0))[1]


def apply_drift(
    u: torch.Tensor, drift: torch.Tensor, prior: torch.Tensor, noise: torch.Tensor, eta: float
) -> torch.Tensor:
    """U' = U - eta (drift + prior(U)) + sqrt(2 eta) noise, the end of the
    kernel's update in plain PyTorch, for the data drift D^T dc summed over
    the data ranks (the matrix prior's product is one torch.matmul)."""
    prior_drift = prior[:, None] * u if prior.ndim == 1 else prior @ u
    return u - eta * (drift + prior_drift) + math.sqrt(2.0 * eta) * noise


def fused_update_reference(
    p: torch.Tensor,
    d: torch.Tensor,
    y: torch.Tensor,
    u: torch.Tensor,
    prior: torch.Tensor,
    noise: torch.Tensor,
    kind: str,
    *,
    eta: float,
    params=(0.0, 0.0),
    mean_shift: float = 0.0,
) -> torch.Tensor:
    """The kernel's math in plain PyTorch, in the input's dtype."""
    drift = fused_drift_reference(p, d, y, u, kind, params=params, mean_shift=mean_shift)
    return apply_drift(u, drift, prior, noise, eta)


def _launch(p, d, y, u, prior, noise, kind, eta, params, mean_shift):
    """Launch the kernel on CUDA tensors; ``prior`` None is the partial mode.
    Returns the (M, J) fp32 output: U', or D^T dc in the partial mode."""
    if u.device.type != "cuda":
        raise ValueError(f"fused_update: particles on {u.device}")
    if p.ndim != 2 or u.ndim != 2 or p.shape[1] != u.shape[0]:
        raise ValueError(f"fused_update: P {tuple(p.shape)} and U {tuple(u.shape)}")
    n, m = p.shape
    j = u.shape[1]
    partial = prior is None
    checked = [("D", d, (n, m)), ("y", y, (n,))]
    if not partial:
        prior_shape = (m,) if prior.ndim == 1 else (m, m)
        checked += [("prior", prior, prior_shape), ("noise", noise, (m, j))]
    for name, t, shape in checked:
        if t.shape != shape or t.device != u.device:
            raise ValueError(f"fused_update: {name} of shape {tuple(t.shape)} on {t.device}")
    if max(n * j, n * m, m * j) >= 2**31:
        raise ValueError("fused_update: a matrix has 2^31 or more elements")
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    # D in place when it or its transpose is contiguous fp32 (k(Z, X).T)
    d_kmajor = not (d.dtype == torch.float32 and d.T.is_contiguous() and not d.is_contiguous())
    d32 = f32(d) if d_kmajor else d.T
    p32, y32, u32 = (f32(t) for t in (p, y, u))
    # the partial mode reads no prior and no noise: U stands in for both
    prior32, noise32 = (u32, u32) if partial else (f32(prior), f32(noise))
    prior_diag = partial or prior.ndim == 1
    depth = n if prior_diag else -(-n // tc_product.TILE_K) * tc_product.TILE_K + m
    upd = tc_product.split_k(m, j, depth)  # an arrival counter per tile
    with torch.cuda.device(u.device):
        dc = torch.empty((n, j), dtype=torch.float32, device=u.device)
        out = torch.empty((m, j), dtype=torch.float32, device=u.device)
        slabs = torch.empty(max(upd.slab, 1), dtype=torch.float32, device=u.device)
        counters = torch.empty(upd.tiles, dtype=torch.int32, device=u.device)
        err = build.load("fused_update", _SIGNATURES).plst_fused_update(
            p32.data_ptr(), d32.data_ptr(), y32.data_ptr(), u32.data_ptr(), prior32.data_ptr(),
            noise32.data_ptr(), dc.data_ptr(), out.data_ptr(), slabs.data_ptr(),
            counters.data_ptr(), n, m, j, int(d_kmajor), int(prior_diag), int(partial),
            cost_forms.COST_KINDS.index(kind), upd.slices, params[0], params[1],
            float(mean_shift), float(eta),
            torch.cuda.current_stream().cuda_stream,
        )
        build.check(err, "fused_update kernel")
    return out


def fused_update(
    p: torch.Tensor,
    d: torch.Tensor,
    y: torch.Tensor,
    u: torch.Tensor,
    prior: torch.Tensor,
    noise: torch.Tensor,
    kind: str,
    *,
    eta: float,
    params=(0.0, 0.0),
    mean_shift: float = 0.0,
) -> torch.Tensor:
    """One update U' in ``u``'s dtype. ``p`` and ``d`` are (N, M) (``d`` may
    be the transpose of an (M, N) tensor, which is read in place); ``prior``
    is (M,) for a diagonal prior or (M, M); ``noise`` (M, J) is added as it
    is, times sqrt(2 eta). On CUDA tensors the kernel runs in fp32; on CPU
    tensors the plain version."""
    _check_kind(kind, "fused_update")
    params = tuple(float(v) for v in params)
    if u.device.type == "cpu":
        return fused_update_reference(p, d, y, u, prior, noise, kind, eta=eta, params=params,
                                      mean_shift=mean_shift)
    out = _launch(p, d, y, u, prior, noise, kind, eta, params, mean_shift)
    fused_update.launches += 1
    return out.to(u.dtype)


def fused_drift(
    p: torch.Tensor,
    d: torch.Tensor,
    y: torch.Tensor,
    u: torch.Tensor,
    kind: str,
    *,
    params=(0.0, 0.0),
    mean_shift: float = 0.0,
) -> torch.Tensor:
    """D^T dc (M, J) in ``u``'s dtype, with dc at F = P U + m0 over the rows
    of ``p``, ``d`` and ``y`` (a data rank's): the kernel's partial mode on
    CUDA tensors (fp32), the plain version on CPU tensors."""
    _check_kind(kind, "fused_drift")
    params = tuple(float(v) for v in params)
    if u.device.type == "cpu":
        return fused_drift_reference(p, d, y, u, kind, params=params, mean_shift=mean_shift)
    out = _launch(p, d, y, u, None, None, kind, 0.0, params, mean_shift)
    fused_drift.launches += 1
    return out.to(u.dtype)


fused_update.launches = 0
fused_drift.launches = 0
