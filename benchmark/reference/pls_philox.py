"""Plain reference of a PLS training run on the ``general_fused`` tier, whose
kernel draws its Langevin normals itself: the normals rebuilt from the
call's seed, and the preconditioned loop on them.

The normals. ``train_pls`` takes the kernel's 64-bit seed as the first
``torch.randint(0, 2**62, (1,))`` of the call's generator. Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011; the
Random123 library) runs under the key (seed mod 2^32, seed div 2^32). The
normals of update t at row r and columns 4g .. 4g + 3 come from one call on
the counter (g, r, t, 1): words (x, y) give one Box-Muller pair for columns
4g and 4g + 1, words (z, w) one for 4g + 2 and 4g + 3. A word's uniform is
((bits >> 8) + 1) 2^-24, in (0, 1]; a pair is sqrt(-2 ln u1) (cos 2 pi u2,
sin 2 pi u2). Philox runs on int64 tensors with each 32 x 32-bit product
taken in 16-bit limbs, so that no value passes 2^50; Box-Muller runs in
fp64.

The loop, on the model of :mod:`benchmark.reference.pls` (its basis, cost,
GH16 quadrature and MAP mean constant):

    U' = e^-eta (U - eta Lambda P^T dc(P U + m0)) + sqrt(Lambda (1 - e^-2eta)) eps,

the decay applied as x - (1 - e^-eta) x with 1 - e^-eta from expm1 (in fp32 a
rounded e^-eta would bias every step alike), with the energy of each update,
the mean over particles of cost_j + 0.5 U_j^T Lambda^-1 U_j at the updated
particles. :func:`train` computes it in fp64; with ``tf32_products`` it
computes it in fp32 with both products in one TF32 pass: each operand rounded
to TF32's 10-bit mantissa, the products and their sums in fp32, as the tensor
cores' single pass computes them.
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark.reference.pls import Model, cast, cost, cost_derivative

MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
# update steps whose normals are drawn at once
STEPS_PER_DRAW = 64


def philox_seed(call_seed: int, device) -> int:
    """The kernel's seed of a ``train_pls`` call whose generator was seeded
    with ``call_seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(call_seed))
    return int(torch.randint(0, 2**62, (1,), generator=gen, device=device))


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of the 64-bit product of the constant
    ``m`` and the words ``x`` (int64, each below 2^32), in 16-bit limbs."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    low = ml * xl
    mid = ml * xh + mh * xl  # below 2^33
    lo = low + ((mid & 0xFFFF) << 16)  # below 2^33
    hi = mh * xh + (mid >> 16) + (lo >> 32)
    return hi & MASK32, lo & MASK32


def philox4x32_10(ctr, key):
    """The four output words of Philox4x32-10 for counters ``ctr`` (four
    int64 tensors or ints, broadcast together, each below 2^32) under
    ``key`` (two ints below 2^32)."""
    device = next((c.device for c in ctr if isinstance(c, torch.Tensor)), None)
    x, y, z, w = (torch.as_tensor(c, dtype=torch.int64, device=device) for c in ctr)
    x, y, z, w = torch.broadcast_tensors(x, y, z, w)
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M[0], x)
        hi1, lo1 = _mulhilo(_M[1], z)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0, k1 = (k0 + _W[0]) & MASK32, (k1 + _W[1]) & MASK32
    return x, y, z, w


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """The uniform in (0, 1] of each word, in fp64 (exact)."""
    return ((bits >> 8) + 1).double() * 2.0**-24


def _box_muller(a: torch.Tensor, b: torch.Tensor):
    r = torch.sqrt(-2.0 * torch.log(uniform24(a)))
    theta = 2.0 * math.pi * uniform24(b)
    return r * torch.cos(theta), r * torch.sin(theta)


def normals(seed: int, m: int, j: int, first_step: int, steps: int, device) -> torch.Tensor:
    """The normals of updates ``first_step`` .. ``first_step + steps - 1``
    of an (m, j) run keyed on ``seed``: fp64, (steps, m, j)."""
    groups = (j + 3) // 4
    t = torch.arange(first_step, first_step + steps, dtype=torch.int64, device=device)
    r = torch.arange(m, dtype=torch.int64, device=device)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    x, y, z, w = philox4x32_10((g[None, None, :], r[None, :, None], t[:, None, None], 1),
                               (seed & MASK32, seed >> 32))
    z0, z1 = _box_muller(x, y)
    z2, z3 = _box_muller(z, w)
    # column 4 g + q takes entry q of group g
    return torch.stack([z0, z1, z2, z3], dim=-1).reshape(steps, m, 4 * groups)[:, :, :j]


def tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 ``a`` rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass: the operands rounded to TF32, exact products,
    fp32 sums."""
    return tf32(a) @ tf32(b)


@contextlib.contextmanager
def no_tf32():
    """Products at the precision of their operands while inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def train(model: Model, u0: torch.Tensor, eta: float, steps: int, seed: int,
          tf32_products: bool = False):
    """``(U, energies)`` after ``steps`` preconditioned updates from ``u0``
    on the kernel's normals of ``seed``; ``model`` in fp64 (its m0 too).
    fp64 throughout, or with ``tf32_products`` fp32 with one TF32 pass a
    product."""
    dtype = torch.float32 if tf32_products else torch.float64
    product = tf32_product if tf32_products else torch.matmul
    model = cast(model, dtype)
    p, lam = model.projection, model.lam[:, None]
    pt = p.T.contiguous()
    one_minus_dec = -math.expm1(-eta)
    nscale = torch.sqrt(lam * -math.expm1(-2.0 * eta))
    m, j = u0.shape
    energies = []
    with no_tf32():
        u = u0.to(dtype)
        f = product(p, u) + model.m0
        for first in range(0, steps, STEPS_PER_DRAW):
            count = min(STEPS_PER_DRAW, steps - first)
            eps = normals(seed, m, j, first, count, u.device).to(dtype)
            for k in range(count):
                drift = lam * product(pt, cost_derivative(model, f))
                x = u - eta * drift
                u = x - one_minus_dec * x + nscale * eps[k]
                f = product(p, u) + model.m0
                energies.append(torch.mean(cost(model, f) + 0.5 * torch.sum(u * u / lam, dim=0)))
    return u, torch.stack(energies).double().tolist() if energies else []
