"""Training entry points (counterpart of ``experiments/trainers.py``): thin
wrappers over the port's trainers. Where the JAX harness passes keys, these
pass integer seeds, from which the port makes ``torch.Generator``s on the
data's device."""

from __future__ import annotations

import torch
import torch.distributed as dist

from experiments_torch.data import Data
from projected_langevin_sampling_torch.models.gaussian_process import (
    SVGP,
    ExactGP,
    init_svgp,
)
from projected_langevin_sampling_torch.models.gaussian_process.training import (
    fit_exact_gp,
    fit_svgp,
)
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.kernels import ARDKernel
from projected_langevin_sampling_torch.training import train_pls as _train_pls


def train_pls(
    pls: PLS,
    particles: torch.Tensor,
    number_of_epochs: int,
    step_size: float,
    early_stopper_patience: float,
    seed: int | None = None,
    fast_path: str = "auto",
    discretisation: str = "euler",
    parallel: dict | None = None,
) -> tuple[torch.Tensor, list[float]]:
    """The particles and the recorded energies of one Langevin run.

    ``parallel`` (``{"data": D, "particles": P}``, a config's
    ``pls.parallel``) runs ``parallel_train_pls`` on a D x P mesh over the
    default process group, one process a device: the group must exist
    (``initialize_multi_host``, or torchrun) and hold exactly D x P ranks,
    else this raises. It never trains on one device instead."""
    seed = seed if seed is not None else 0
    if parallel:
        from projected_langevin_sampling_torch.parallel import make_mesh, parallel_train_pls

        n_data, n_particles = int(parallel.get("data", 1)), int(parallel.get("particles", 1))
        world = dist.get_world_size() if dist.is_initialized() else None
        if world != n_data * n_particles:
            have = "none is initialised" if world is None else f"the default group has {world}"
            raise ValueError(f"parallel={parallel} needs a process group of "
                             f"{n_data * n_particles} ranks (one a device); {have}")
        mesh = make_mesh(n_data, n_particles, device=particles.device)
        result = parallel_train_pls(
            mesh,
            pls,
            particles=particles,
            number_of_epochs=number_of_epochs,
            step_size=step_size,
            early_stopper_patience=early_stopper_patience,
            seed=seed,
            fast_path=fast_path,
            discretisation=discretisation,
        )
        energies = [
            float(e) for e, r in zip(result.energies.tolist(), result.recorded.tolist()) if r
        ]
        return result.particles, energies
    return _train_pls(
        pls=pls,
        particles=particles,
        number_of_epochs=number_of_epochs,
        step_size=step_size,
        early_stopper_patience=early_stopper_patience,
        seed=seed,
        fast_path=fast_path,
        discretisation=discretisation,
    )


def train_exact_gp(
    data: Data,
    kernel: ARDKernel,
    seed: int,
    number_of_epochs: int,
    learning_rate: float,
    early_stopper_patience: float,
    noise: float = 1.0,
    mean_constant: float = 0.0,
    fixed_noise_variances=None,
) -> tuple[ExactGP, list[float]]:
    """Adam on the exact MLL; deterministic given the data, so ``seed`` is
    unused (as in the JAX harness)."""
    del seed
    return fit_exact_gp(
        x=data.x,
        y=data.y,
        kernel=kernel,
        noise=noise,
        mean_constant=mean_constant,
        learning_rate=learning_rate,
        number_of_epochs=number_of_epochs,
        early_stopper_patience=early_stopper_patience,
        fixed_noise_variances=fixed_noise_variances,
    )


def train_svgp(
    train_data: Data,
    inducing_points: Data,
    kernel,
    likelihood,
    seed: int,
    number_of_epochs: int,
    batch_size: int,
    learning_rate: float,
    learn_inducing_locations: bool,
    learn_kernel_parameters: bool,
    early_stopper_patience: float,
    likelihood_noise: float | None = None,
    mean_constant: float = 0.0,
) -> tuple[SVGP | None, list[float] | None]:
    """SGD on the minibatched ELBO; the epochs' permutations come from a
    generator seeded with ``seed``. ``likelihood_noise`` only initialises
    the likelihood's noise, which is then learned (the reference's
    semantics)."""
    if likelihood_noise is not None and hasattr(likelihood, "noise"):
        likelihood = likelihood.replace(
            noise=torch.as_tensor(likelihood_noise, dtype=inducing_points.x.dtype,
                                  device=inducing_points.x.device)
        )
    svgp = init_svgp(
        mean_constant=mean_constant,
        kernel=kernel,
        likelihood=likelihood,
        x_induce=inducing_points.x,
    )
    return fit_svgp(
        svgp,
        x=train_data.x,
        y=train_data.y,
        number_of_epochs=number_of_epochs,
        batch_size=batch_size,
        learning_rate=learning_rate,
        learn_inducing_locations=learn_inducing_locations,
        learn_kernel_parameters=learn_kernel_parameters,
        learn_observation_noise=True,
        early_stopper_patience=early_stopper_patience,
        generator=seed,
    )
