"""Multi-card training with the particles sharded over the mesh's particle
axis (counterpart of ``projected_langevin_sampling_tpu/parallel/auto.py``).

The semantics of ``training.train_pls``: the same tier resolution and the
same W-space reroute of an inducing-point model (the port's own
``needs_w_space_reroute``, ``ipb_w_space_view`` and ``resolve_tier``, so the
two entry points cannot drift), the basis and the cost whole on every rank.

Here the port departs from the JAX package on purpose. JAX hands the whole
run to its SPMD partitioner and drops the fused tiers to their unfused
parents, because the partitioner cannot split a Pallas custom call. The port
partitions by hand: each particle rank runs its tier on its own columns, the
whole-run kernel of the tier included (B1 spectral, B3 general_fused, B4
quadratic_fused), with no communication inside the run, since the particles
are coupled only through the energy.

This module alone holds the run's early stop (:func:`train_to_global_stop`),
the same for every tier, on the CPU and the card: a rank runs its columns
with infinite patience (a kernel's own stopper, or the loop's, would see
only the rank's share of the energy), the shares are summed over the
particle ranks (one all-reduce a run, a vector of T), the stopper is
replayed on that trace, and if it stops before the end the rank reruns steps
0..stop from U0 on the same draws: ``train_pls``'s stop, at most one rerun.

The draws are the single-device run's, as threefry gives JAX's partitioned
run (``auto.py:9-11`` there): the kernels count their Philox groups on the
run's column (``utils/columns.py``), and the loops draw the whole (M, J)
normals and keep their columns. So a run equals ``train_pls`` with the same
generator up to the order of the energy sums. The JAX package's chunked
runner of long runs is not needed (``training._train_pls_chunked``).
"""

from __future__ import annotations

import math

import torch

from projected_langevin_sampling_torch.parallel.mesh import (
    PARTICLE_AXIS,
    axis,
    gather_columns,
    particle_columns,
    summer,
)
from projected_langevin_sampling_torch.training import (
    DISCRETISATIONS,
    TrainResult,
    _require_known_basis,
    _train_pls_loop,
    ipb_w_space_view,
    needs_w_space_reroute,
    resolve_tier,
    spectral_system_host,
)
from projected_langevin_sampling_torch.utils.columns import ColumnShard
from projected_langevin_sampling_torch.utils.early_stopper import replay_early_stopper
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


def train_to_global_stop(run, number_of_epochs: int, step_size: float, patience: float,
                         reduce) -> TrainResult:
    """A particle shard's run with the whole run's early stop.

    ``run(num_steps)`` trains the shard from U0 with infinite patience on the
    same draws at every call and returns its ``TrainResult``, whose energies
    are the shard's share; ``reduce`` sums a tensor over the particle ranks.
    Every rank takes the same decision from the same summed trace, so every
    rank reruns or none does. Returns the shard's particles with the run's
    energies, recorded flags and stop."""
    result = run(number_of_epochs)
    energies = reduce(result.energies)
    recorded, steps_run = replay_early_stopper(energies, step_size, patience)
    stop = int(steps_run)
    particles = result.particles
    if stop < number_of_epochs:
        # the stop step's update is applied, as in train_pls
        particles = run(stop).particles
        energies[stop:] = math.nan
    return TrainResult(particles, energies, recorded, steps_run)


def parallel_train_pls(
    mesh,
    pls_or_basis,
    cost=None,
    particles: torch.Tensor | None = None,
    number_of_epochs: int = 1,
    step_size: float = 1e-3,
    early_stopper_patience: float = math.inf,
    generator: GeneratorLike = None,
    seed: int | None = None,
    fast_path: str = "auto",
    discretisation: str = "euler",
    noise: torch.Tensor | None = None,
) -> TrainResult:
    """Train the whole (M, J) ``particles``, sharded by columns over the
    mesh's particle axis; returns the ``TrainResult`` of the whole run on
    every rank (the particles gathered once at the end; the energies,
    recorded flags and stop the run's).

    ``noise`` (T, M, J) injects the normals z of the whole run, as
    ``training._train_pls_loop`` takes them (CPU tensors on the fused tiers);
    each rank uses its own columns.

    Shards are :func:`~projected_langevin_sampling_torch.parallel.mesh.particle_columns`'
    columns. On more than one particle rank the spectral tier needs J a
    multiple of 4, on the CPU as on the card (its kernel draws in groups of
    four of the run's elements); the other tiers take any J."""
    if discretisation not in DISCRETISATIONS:
        # before needs_w_space_reroute, which would read an unknown value as
        # non-Euler and reroute an inducing-point basis
        raise ValueError(f"Unknown discretisation {discretisation!r}")
    if cost is None:  # called with a PLS facade
        basis, cost = pls_or_basis.basis, pls_or_basis.cost
    else:
        basis = pls_or_basis
    if generator is None and seed is not None:
        generator = seed
    _require_known_basis(basis)
    exit_map = None
    if needs_w_space_reroute(basis, fast_path, discretisation):
        basis, s_mat, s_inv = ipb_w_space_view(basis)
        particles = s_inv @ particles
        exit_map = lambda u: s_mat @ u  # noqa: E731
    tier = resolve_tier(basis, cost, fast_path, discretisation)
    group, size, index = axis(mesh, PARTICLE_AXIS)
    j_total = particles.shape[1]
    if tier == "spectral" and size > 1 and j_total % 4:
        raise ValueError(
            f"parallel_train_pls: the spectral tier on {size} particle ranks needs J a multiple "
            f"of 4, not {j_total}: its kernel draws its normals in groups of four of the run's "
            "elements, and a shard must hold whole groups"
        )
    j0, j_loc = particle_columns(j_total, size, index)
    columns = slice(j0, j0 + j_loc)
    system = spectral_system_host(basis, cost, discretisation) if tier == "spectral" else None
    generator = as_generator(generator, device=particles.device)
    start = generator.get_state()

    def run(steps: int, patience: float, shard: ColumnShard | None) -> TrainResult:
        generator.set_state(start)  # every run of the shard on the same draws
        return _train_pls_loop(
            basis, cost, particles[:, columns], step_size, patience, steps, tier, system,
            generator=generator, noise=None if noise is None else noise[..., columns],
            discretisation=discretisation, shard=shard,
        )

    if size == 1:
        result = run(int(number_of_epochs), early_stopper_patience, None)
    else:
        shard = ColumnShard(j0, j_total)
        result = train_to_global_stop(
            lambda steps: run(steps, math.inf, shard), int(number_of_epochs), step_size,
            early_stopper_patience, summer(group, size),
        )
    u = gather_columns(result.particles, group, size, j_total)
    return result._replace(particles=u if exit_map is None else exit_map(u))
