"""Particle column shards: a rank of ``parallel/auto.py`` trains columns
j0 .. j0 + J_loc of a J-column run.

Its draws are those columns of the whole run's: the plain loops draw the
whole (M, J) normals from the generator and keep their columns, and the
whole-run kernels count their Philox groups on the run's column. Its
energies are its share of the run's mean, the sum of its columns' energies
over J (the constant's share included), so the shares of all shards sum to
the run's energies. Nothing here communicates: ``parallel/auto.py`` sums the
shares over the ranks and decides the run's early stop. ``shard=None``
everywhere means the whole run, with the code paths of an unsharded call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ColumnShard(NamedTuple):
    j0: int  # the run's column of local column 0
    j_total: int  # the run's J


def column_mean(per_column: torch.Tensor, shard: ColumnShard | None = None) -> torch.Tensor:
    """The run's mean over its columns of a per-column quantity (J_loc,):
    ``torch.mean`` unsharded; else the shard's share, its sum over J."""
    if shard is None:
        return torch.mean(per_column)
    return per_column.sum() / shard.j_total


def column_normals(shape, generator: torch.Generator, dtype, device,
                   shard: ColumnShard | None = None) -> torch.Tensor:
    """Standard normals of ``shape`` (M, J_loc) from ``generator``: with a
    shard, its columns of the whole run's (M, J) draw."""
    if shard is None:
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    m, j = shape
    z = torch.randn((m, shard.j_total), generator=generator, dtype=dtype, device=device)
    return z[:, shard.j0:shard.j0 + j]


def constant_share(e_const: float, j: int, shard: ColumnShard | None) -> float:
    """A shard's share of a per-column energy constant, J_loc / J of it (the
    constant itself unsharded, bit for bit)."""
    return e_const if shard is None else e_const * (j / shard.j_total)

