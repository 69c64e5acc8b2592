"""Device meshes for multi-card PLS over ``torch.distributed`` (counterpart of
``projected_langevin_sampling_tpu/parallel/mesh.py``).

The scaling axes are J (particles, embarrassingly parallel) and N (training
data, one all-reduce a step of the projected cost gradient). A mesh has the
axes ("data", "particles"): the (N, M) train projection and the labels are
cut by rows over "data", the (M, J) particles by columns over "particles";
M stays whole on every rank.

One process (rank) drives one card, as ``torchrun`` starts them, and a mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group. The JAX package's ``simulate_cpu_devices`` (several virtual
devices in one process) has no counterpart here: ``device="cpu"`` runs each
rank on the CPU with gloo, which is how the tests run several ranks.

The helpers below give a rank its share: :func:`particle_columns` and
:func:`data_rows` cut J and N the same way on every rank, :func:`axis` reads
a rank's place on an axis, :func:`summer` sums a tensor over an axis and
:func:`gather_columns` puts the particle shards back together, and
:func:`gather_blocks` the blocks of a mesh-sharded chunked predict.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from projected_langevin_sampling_torch.utils.device import resolve_device

DATA_AXIS = "data"
PARTICLE_AXIS = "particles"


def _backend(device) -> str:
    return "gloo" if resolve_device(device).type == "cpu" else "nccl"


def _use_card(rank: int) -> None:
    """Make this rank's card the current one: ``LOCAL_RANK`` where torchrun
    sets it, else the rank modulo the cards of the host."""
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))


def initialize_multi_host(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> tuple[int, int]:
    """Join the process group of a multi-process run; returns ``(rank,
    world_size)``.

    Arguments default from torchrun's environment (where the JAX package
    reads ``JAX_*``): ``MASTER_ADDR`` and ``MASTER_PORT`` name the
    coordinator, ``WORLD_SIZE`` and ``RANK`` the processes.
    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``tcp://``, ``file://``, ``env://``). NCCL on the card, with this rank
    on card ``LOCAL_RANK`` (else the rank modulo the host's cards); gloo only
    when the caller asks for the CPU (``device="cpu"``).

    Idempotent: once the group exists, a call returns its rank and size. A
    single process with nothing to coordinate (no address, no process count
    anywhere) is a no-op returning ``(0, 1)``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = "env://"
    if coordinator_address is None and num_processes is None:
        return 0, 1
    init_method = coordinator_address or "env://"
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    backend = _backend(device)
    if backend == "nccl":
        _use_card(process_id or 0)
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_data: int | None = None, n_particles: int | None = None,
              device=None) -> DeviceMesh:
    """A (data, particles) mesh over the ranks of the process group.
    Defaults: every rank on the particle axis (the direction with no
    communication a step). A lone process with no group gets a group of
    one, kept in its own memory."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1)
    n_dev = dist.get_world_size()
    if n_data is None and n_particles is None:
        n_data, n_particles = 1, n_dev
    elif n_data is None:
        n_data = n_dev // n_particles
    elif n_particles is None:
        n_particles = n_dev // n_data
    assert n_data * n_particles == n_dev, f"mesh {n_data}x{n_particles} != {n_dev} devices"
    return init_device_mesh(resolve_device(device).type, (n_data, n_particles),
                            mesh_dim_names=(DATA_AXIS, PARTICLE_AXIS))


def axis(mesh: DeviceMesh, name: str):
    """``(group, size, index)`` of this rank on the mesh axis ``name``."""
    group = mesh.get_group(name)
    return group, dist.get_world_size(group), mesh.get_local_rank(name)


def summer(group, size: int):
    """A function that returns a tensor summed over ``group``; None for a
    group of one, where the sum is the tensor itself."""
    if size == 1:
        return None

    def reduce(t: torch.Tensor) -> torch.Tensor:
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    return reduce


def _shard(total: int, size: int, index: int, multiple: int, what: str) -> tuple[int, int]:
    chunk = -(-total // size)  # ceil(total / size), then up to a multiple
    chunk = -(-chunk // multiple) * multiple
    start = index * chunk
    count = min(chunk, total - start)
    if count <= 0:
        raise ValueError(f"{total} {what} leave shard {index} of {size} empty "
                         f"(shards of {chunk})")
    return start, count


def particle_columns(j_total: int, size: int, index: int) -> tuple[int, int]:
    """``(j0, J_loc)`` of particle shard ``index`` of ``size``: shards of
    ceil(J / size) columns rounded up to a multiple of 4 (the whole-run
    kernels count their normals in groups of four columns), the last one
    shorter. Raises if a shard would be empty."""
    return _shard(j_total, size, index, 4, "particles")


def data_rows(n: int, size: int, index: int) -> tuple[int, int]:
    """``(r0, N_loc)`` of data shard ``index`` of ``size``: shards of
    ceil(N / size) rows, the last one shorter. Raises if one would be
    empty."""
    return _shard(n, size, index, 1, "training points")


def gather_columns(local: torch.Tensor, group, size: int, j_total: int) -> torch.Tensor:
    """The whole (M, J) matrix on every rank of ``group`` from each rank's
    :func:`particle_columns` shard (one all-gather; shards padded to one
    width)."""
    if size == 1:
        return local
    chunk = particle_columns(j_total, size, 0)[1]
    padded = local.new_zeros((local.shape[0], chunk))
    padded[:, :local.shape[1]] = local
    parts = [torch.empty_like(padded) for _ in range(size)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat(parts, dim=1)[:, :j_total]


def gather_blocks(local: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``local`` blocks (each rank as many) stacked along the
    first axis in rank order, on every rank of ``group`` (one all-gather)."""
    if size == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts)
