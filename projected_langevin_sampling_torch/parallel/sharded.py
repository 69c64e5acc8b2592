"""Multi-card Langevin steps over a (data, particles) mesh (counterpart of
``projected_langevin_sampling_tpu/parallel/sharded.py``).

A rank holds the rows of P, D and y of its data rank and the columns of U of
its particle rank (its ``DeviceMesh`` coordinates); the data ranks of one
particle rank hold the same columns:

    U      (M, J_loc)   the particle rank's columns (:func:`particle_columns`)
    P, D   (N_loc, M)   the data rank's rows (:func:`data_rows`)
    drift  D_loc^T dc(P_loc U + m0), then ONE all-reduce over "data"
    prior, noise        local to the particle shard (M whole)

On a mesh whose data axis is 1 a step is the fused-update kernel B5, the
call ``training.langevin_steps`` makes. With more data ranks, B5's partial
mode (``ops/cuda/fused_update.fused_drift``) gives D_loc^T dc, the
all-reduce sums it over "data", and ``apply_drift`` finishes the step (the
matrix prior's M x M x J_loc product in torch.matmul, which the JAX sharded
path also leaves outside any kernel). A cost with no closed form in B5 takes
the same route in plain torch. On CPU tensors B5 is its plain version.

:func:`parallel_langevin_steps` draws its noise from a generator seeded
from (seed, particle rank), so the data ranks of a column shard draw the
same noise and U stays the same on them with no communication; the draws
differ from the single-device stream (JAX ``sharded.py:165, 218-220``).
:func:`parallel_langevin_steps_with_noise` injects the update noise itself
(S z on the inducing-point basis) for parity tests. Both take the whole
model and the whole (M, J) particles on every rank, cut their own share, and
return the whole (M, J) particles on every rank (one all-gather over
"particles" at the end).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from projected_langevin_sampling_torch.closed_forms import dc_kind_for_cost
from projected_langevin_sampling_torch.models.basis.inducing_point import InducingPointBasis
from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.ops.cuda.fused_update import (
    apply_drift,
    fused_drift,
    fused_update,
)
from projected_langevin_sampling_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    axis,
    data_rows,
    gather_columns,
    particle_columns,
    summer,
)
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator

# the per-row fields of the port's costs, cut over "data" with P and D
_COST_ROW_FIELDS = ("y_train", "smoothing_std")


@dataclasses.dataclass(frozen=True)
class ShardedPLSOperators:
    """The arrays a step touches, taken from a basis.

    train_projection  P: F = P @ U + m0                 (N, M)
    data_drift        D: data drift = D^T @ dc(F)       (N, M)
    prior_diag / prior_matrix: the prior drift's operator, (M,) or (M, M)
    noise_factor: update noise = factor @ z, or None for iid N(0, I)
    energy_matrix, energy_scale: the per-particle prior energy's operator
    and scale (IPB: K^{-1}; ONB: None, which uses prior_diag), the JAX
    dataclass's fields; the steps here take the energy from the basis
    (``calculate_particle_energies``)
    """

    train_projection: torch.Tensor
    data_drift: torch.Tensor
    prior_diag: torch.Tensor | None
    prior_matrix: torch.Tensor | None
    noise_factor: torch.Tensor | None
    energy_matrix: torch.Tensor | None
    energy_scale: float = 1.0
    mean_constant: float = 0.0


def operators_from_basis(basis) -> ShardedPLSOperators:
    if isinstance(basis, OrthonormalBasis):
        return ShardedPLSOperators(
            train_projection=basis.train_projection,
            data_drift=basis.train_projection,
            prior_diag=1.0 / basis.eigenvalues,
            prior_matrix=None,
            noise_factor=None,
            energy_matrix=None,
            energy_scale=0.5,
            mean_constant=basis.mean_constant,
        )
    if isinstance(basis, InducingPointBasis):
        m = basis.approximation_dimension
        return ShardedPLSOperators(
            train_projection=basis.train_projection,
            data_drift=basis.base_gram_induce_train.T,
            prior_diag=None,
            prior_matrix=m * basis.inv_base_gram_induce,
            noise_factor=basis.noise_factor,
            energy_matrix=basis.inv_base_gram_induce,
            energy_scale=0.5 * m,
            mean_constant=basis.mean_constant,
        )
    raise TypeError(f"Unsupported basis type {type(basis)}")


def _rows(t: torch.Tensor, r0: int, n_loc: int) -> torch.Tensor:
    """Rows r0 .. r0 + n_loc of an (N, M) operator, in a layout B5 reads in
    place (rows of it or of its transpose contiguous)."""
    if r0 == 0 and n_loc == t.shape[0]:
        return t
    t = t[r0:r0 + n_loc]
    return t if t.is_contiguous() or t.T.is_contiguous() else t.contiguous()


class _Step:
    """One Langevin step of this rank's share: its rows, its columns."""

    def __init__(self, mesh, basis, cost, j_total: int, eta: float):
        self.basis = basis
        ops = operators_from_basis(basis)
        n = ops.train_projection.shape[0]
        data_group, data_size, data_index = axis(mesh, DATA_AXIS)
        self.particle_group, self.particle_size, particle_index = axis(mesh, PARTICLE_AXIS)
        r0, n_loc = data_rows(n, data_size, data_index)
        self.j0, self.j_loc = particle_columns(j_total, self.particle_size, particle_index)
        self.j_total = j_total
        self.ops, self.eta = ops, float(eta)
        self.p = _rows(ops.train_projection, r0, n_loc)
        self.d = _rows(ops.data_drift, r0, n_loc)
        self.cost = cost if n_loc == n else dataclasses.replace(cost, **{
            name: getattr(cost, name)[r0:r0 + n_loc]
            for name in _COST_ROW_FIELDS if hasattr(cost, name)
        })
        self.prior = ops.prior_diag if ops.prior_diag is not None else ops.prior_matrix
        self.data_sum = summer(data_group, data_size)
        self.particle_sum = summer(self.particle_group, self.particle_size)
        self.dc_spec = dc_kind_for_cost(cost)

    def columns(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a (..., J) tensor."""
        return t[..., self.j0:self.j0 + self.j_loc]

    def __call__(self, u: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """U' from this rank's U (M, J_loc) and update noise (M, J_loc)."""
        m0 = self.ops.mean_constant
        if self.dc_spec is None:  # no closed form in B5: the plain drift
            dc = self.cost.calculate_cost_derivative(self.p @ u + m0)
            drift = self.d.T @ dc
        else:
            kind, params = self.dc_spec
            if self.data_sum is None:  # every row here: B5 as langevin_steps calls it
                return fused_update(self.p, self.d, self.cost.y_train, u, self.prior, noise, kind,
                                    eta=self.eta, params=params, mean_shift=m0)
            drift = fused_drift(self.p, self.d, self.cost.y_train, u, kind, params=params,
                                mean_shift=m0)
        if self.data_sum is not None:
            drift = self.data_sum(drift)
        return apply_drift(u, drift, self.prior, noise, self.eta)

    def energy(self, u: torch.Tensor) -> torch.Tensor:
        """The run's mean energy after a step: the cost summed over "data",
        the particles' energies summed over "particles", over J."""
        cost_j = self.cost.calculate_cost(self.p @ u + self.ops.mean_constant)
        if self.data_sum is not None:
            cost_j = self.data_sum(cost_j)
        total = torch.sum(self.basis.calculate_particle_energies(u, cost_j))
        if self.particle_sum is not None:
            total = self.particle_sum(total)
        return total / self.j_total

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        return gather_columns(u, self.particle_group, self.particle_size, self.j_total)


def _particle_generator(seed: GeneratorLike, index: int, device) -> torch.Generator:
    """The generator of particle rank ``index``: seeded from (seed, index),
    as the JAX path folds the particle index into its key, so the data ranks
    of one column shard draw the same noise. A generator given as ``seed``
    gives its next draw as the seed (the same on every rank that holds the
    same generator state)."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2**62, (1,), generator=seed, device=seed.device))
    words = np.random.SeedSequence([0 if seed is None else int(seed), index]).generate_state(2)
    return as_generator(int(words[0]) << 32 | int(words[1]), device=device)


def parallel_langevin_steps(
    mesh,
    basis,
    cost,
    particles: torch.Tensor,
    seed: GeneratorLike = None,
    step_size: float = 1e-3,
    n_steps: int = 1,
    with_energy: bool = False,
):
    """``n_steps`` Euler Langevin updates sharded over the mesh; returns
    ``(particles, energies)``, the whole (M, J) particles and, with
    ``with_energy``, the (n_steps,) mean energy after each step (else None).

    The noise comes from a generator per particle rank (module note): the
    law of the single-device ``training.langevin_steps``, not its draws. For
    exact parity use :func:`parallel_langevin_steps_with_noise`."""
    step = _Step(mesh, basis, cost, particles.shape[1], step_size)
    generator = _particle_generator(seed, axis(mesh, PARTICLE_AXIS)[2], particles.device)
    u = step.columns(particles)
    energies = []
    for _ in range(int(n_steps)):
        z = torch.randn(tuple(u.shape), generator=generator, dtype=u.dtype, device=u.device)
        u = step(u, z if step.ops.noise_factor is None else step.ops.noise_factor @ z)
        if with_energy:
            energies.append(step.energy(u))
    if not with_energy:
        return step.gather(u), None
    return step.gather(u), torch.stack(energies) if energies else u.new_zeros(0)


def parallel_langevin_steps_with_noise(
    mesh,
    basis,
    cost,
    particles: torch.Tensor,
    noise: torch.Tensor,
    step_size: float,
) -> torch.Tensor:
    """The deterministic variant for parity tests: ``noise`` (T, M, J) is the
    update noise of every step, added as it is (times sqrt(2 eta)); returns
    the whole (M, J) particles."""
    step = _Step(mesh, basis, cost, particles.shape[1], step_size)
    u = step.columns(particles)
    for noise_t in step.columns(noise):
        u = step(u, noise_t)
    return step.gather(u)
