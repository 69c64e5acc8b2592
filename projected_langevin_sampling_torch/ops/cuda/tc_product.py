"""The tiling of ``csrc/tc_product.cuh``, the tensor-core product of B3
(``general_train``), B4 (``quadratic_train``) and B5 (``fused_update``), and
a plain emulation of its arithmetic.

The header multiplies fp32 matrices on output tiles of ``TILE_M x TILE_N``
(64 x 128, 8 warps) through a ring of depth stages of ``TILE_K`` (32), with
``mma.sync`` on TF32 operands in 3xTF32: each operand ``x`` is split into
``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)`` and a product is
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in fp32, so its error is that of an
fp32 product rather than TF32's 2^-11. A product whose output has few tiles
is split along its depth into :func:`split_k`'s slices, whose partial tiles
the last block of each tile sums in a fixed order.

:func:`split_k` sizes a wrapper's scratch for one product: the tiles of its
output (one arrival counter and one energy partial each), the slices, and
the floats of the slabs of partial tiles. The slice count is a function of
the shape alone (never of the card), so a rerun sums in the same order.

:func:`persistent_phase`, :func:`persistent_grid` and :func:`block_items`
mirror the partition of B4's persistent kernel (``csrc/quadratic_train.cu``):
a step is one phase of ``products`` products of one (rows, cols) output,
each cut into the same slices, and its work items (product, tile, slice),
item ``(product * slices + slice) * tiles + tile``, go to the blocks in
turn, block b taking items b, b + grid, ... every step. The grid is the
card's co-resident block count, capped at the items.

:func:`tf32_rna` and :func:`tf32x3_matmul` repeat the split and the three
products in plain PyTorch, for the tests; nothing on the main path calls
them. They model the operand rounding, not the tensor cores' own order and
rounding of the sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE_M, TILE_N, TILE_K = 64, 128, 32  # BM, BN, BK of csrc/tc_product.cuh
# two blocks on each of the H100 SXM's 132 SMs (the header's MIN_BLOCKS): a
# split product fills one wave of them
BLOCK_SLOTS = 2 * 132
MIN_SLICE_STAGES = 4  # a slice walks at least this many stages of TILE_K


class SplitK(NamedTuple):
    tiles: int  # output tiles: arrival counters, energy partials
    slices: int  # slices of the depth, blocks per tile
    slab: int  # floats of the partial tiles (0 for one slice)


class Phase(NamedTuple):
    tiles: int  # output tiles: arrival counters
    products: int  # products of the phase, each cut into `slices`
    slices: int  # slices of the depth of each product
    items: int  # (product, tile, slice) work items: products x slices x tiles
    slab: int  # floats of the partial tiles: one per item


def tiles(rows: int, cols: int) -> int:
    """Output tiles of a (rows, cols) product."""
    return -(-rows // TILE_M) * -(-cols // TILE_N)


def _slices(n_tiles: int, depth: int, block_slots: int) -> int:
    """Slices of a depth shared by ``n_tiles`` output tiles: as many as
    ``block_slots`` blocks hold, none shallower than ``MIN_SLICE_STAGES``
    stages unless the depth is, and none empty."""
    slices = max(1, min(block_slots // n_tiles, depth // (MIN_SLICE_STAGES * TILE_K)))
    # the kernel's slice depth (tc::slice_depth) is a multiple of TILE_K, so
    # the last slices may be empty: keep only those that hold depth
    per_slice = -(-depth // slices)
    per_slice = -(-per_slice // TILE_K) * TILE_K
    return -(-depth // per_slice)


def split_k(rows: int, cols: int, depth: int) -> SplitK:
    """The split of a (rows, cols) product over ``depth``: as many slices as
    one wave of ``BLOCK_SLOTS`` blocks holds, none shallower than
    ``MIN_SLICE_STAGES`` stages unless the depth is."""
    n_tiles = tiles(rows, cols)
    slices = _slices(n_tiles, depth, BLOCK_SLOTS)
    return SplitK(n_tiles, slices, slices * n_tiles * TILE_M * TILE_N if slices > 1 else 0)


def persistent_phase(rows: int, cols: int, depth: int, products: int = 1,
                     block_slots: int = BLOCK_SLOTS) -> Phase:
    """One phase of B4's persistent kernel: ``products`` (rows, cols) outputs
    over ``depth``, each cut into slices none shallower than
    ``MIN_SLICE_STAGES`` stages unless the depth is: the fewest slices that
    leave a block of ``block_slots`` within a tenth of the least depth to
    multiply (its items times their depth), since every slice adds a partial
    tile to write and read. Every item writes one, even with one slice."""
    n_tiles = tiles(rows, cols)
    loads = {}
    for wanted in range(1, max(1, depth // (MIN_SLICE_STAGES * TILE_K)) + 1):
        per_slice = -(-(-(-depth // wanted)) // TILE_K) * TILE_K  # tc::slice_depth
        slices = -(-depth // per_slice)
        loads.setdefault(slices, -(-products * slices * n_tiles // block_slots) * per_slice)
    least = min(loads.values())
    slices = min(k for k, load in loads.items() if load <= 1.1 * least)
    items = products * slices * n_tiles
    return Phase(n_tiles, products, slices, items, items * TILE_M * TILE_N)


def persistent_grid(phase: Phase, coresident: int = BLOCK_SLOTS) -> int:
    """The grid of a persistent run: the co-resident blocks, capped at the
    items of its phase."""
    return min(coresident, phase.items)


def block_items(block: int, grid: int, phase: Phase):
    """The (product, tile, slice) items of ``phase`` that ``block`` of
    ``grid`` owns, in the order it runs them."""
    for item in range(block, phase.items, grid):
        tile, slice_ = item % phase.tiles, item // phase.tiles
        yield slice_ // phase.slices, tile, slice_ % phase.slices


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), as fp32. Adding half a TF32 unit to the
    magnitude bits and clearing the 13 low bits rounds a tie up in magnitude;
    infinities stay, a finite value past TF32's largest becomes infinite, and
    NaN stays NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_rna: fp32 only, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: x = hi + lo to about 2^-22 of |x|, both TF32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, ``tf32_rna(a) @ tf32_rna(b)`` in fp32: what a 1xTF32
    product would give."""
    return tf32_rna(a) @ tf32_rna(b)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The header's 3xTF32 product in fp32: ``(a_lo b_hi + a_hi b_lo) + a_hi
    b_hi``, the small terms first, ``a_lo b_lo`` dropped."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
