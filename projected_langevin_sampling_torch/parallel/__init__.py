"""Scale-out over ``torch.distributed``: a (data, particles) mesh of ranks,
sharded Langevin steps on the fused-update kernel, whole-run training with
the particles sharded, and (in ``models/pls.PLS.predict_samples(mesh=)``)
chunked serving with its blocks spread over the mesh."""

from projected_langevin_sampling_torch.parallel.auto import parallel_train_pls
from projected_langevin_sampling_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    initialize_multi_host,
    make_mesh,
)
from projected_langevin_sampling_torch.parallel.sharded import (
    ShardedPLSOperators,
    operators_from_basis,
    parallel_langevin_steps,
    parallel_langevin_steps_with_noise,
)

__all__ = [
    "DATA_AXIS",
    "PARTICLE_AXIS",
    "initialize_multi_host",
    "make_mesh",
    "parallel_train_pls",
    "ShardedPLSOperators",
    "operators_from_basis",
    "parallel_langevin_steps",
    "parallel_langevin_steps_with_noise",
]
