"""A rank of the PyTorch port's multi-process tests (started by
``tests/test_torch_parallel.py``; not collected by pytest). It imports no
JAX: the parent passes the models as numpy parameters and compares.

Each rank joins a gloo group through a ``file://`` init method (no TCP port,
so parallel test workers cannot clash), runs the jobs of the task file in
order (every rank the same jobs, so the collectives line up) and writes its
results to ``<out_dir>/rank<r>.pkl``.

Usage: python tests/torch_parallel_worker.py <rank> <world> <init_file> <task.pkl> <out_dir>
"""

from __future__ import annotations

import os
import pickle
import sys


def _model(spec, convert, torch):
    kind, params = spec["basis"]
    basis = (convert.orthonormal_basis_from_numpy if kind == "onb"
             else convert.inducing_point_basis_from_numpy)(params, device="cpu")
    cost_type, cost_params = spec["cost"]
    converter = {
        "GaussianCost": convert.gaussian_cost_from_numpy,
        "BernoulliCost": convert.bernoulli_cost_from_numpy,
        "SmoothedBernoulliCost": convert.smoothed_bernoulli_cost_from_numpy,
    }[cost_type]
    return basis, converter(cost_params, device="cpu"), torch.as_tensor(spec["u0"])


def _mesh_checks(parallel, world):
    """make_mesh's defaults and its assertion."""
    out = {"default": tuple(parallel.make_mesh(device="cpu").shape)}
    if world % 2 == 0:
        out["n_data=2"] = tuple(parallel.make_mesh(n_data=2, device="cpu").shape)
    out["n_particles=1"] = tuple(parallel.make_mesh(n_particles=1, device="cpu").shape)
    try:
        parallel.make_mesh(world + 1, 1, device="cpu")
        out["bad"] = "no error"
    except AssertionError as err:
        out["bad"] = str(err)
    return out


def main() -> int:
    rank, world, init_file, task_file, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from projected_langevin_sampling_torch import convert, parallel
    from projected_langevin_sampling_torch.models.basis.noise_distributions import (
        StudentTPredictiveNoise,
    )
    from projected_langevin_sampling_torch.models.pls import PLS

    joined = parallel.initialize_multi_host(
        coordinator_address=f"file://{init_file}", num_processes=world, process_id=rank,
        device="cpu",
    )
    results = {"joined": joined, "again": parallel.initialize_multi_host()}
    with open(task_file, "rb") as f:
        task = pickle.load(f)
    models = {name: _model(spec, convert, torch) for name, spec in task["models"].items()}
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = parallel.make_mesh(*shape, device="cpu")
        return meshes[shape]

    as_t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    for job in task["jobs"]:
        kind, key = job["kind"], job.get("key")
        if kind == "mesh":
            results["mesh"] = _mesh_checks(parallel, world)
            continue
        basis, cost, u0 = models[job["model"]]
        if kind == "steps_noise":
            got = parallel.parallel_langevin_steps_with_noise(
                mesh(job["mesh"]), basis, cost, u0, as_t(job["noise"]), job["eta"])
            results[key] = got.numpy()
        elif kind == "steps_energy":
            final, energies = parallel.parallel_langevin_steps(
                mesh(job["mesh"]), basis, cost, u0, job["seed"], job["eta"], job["steps"],
                with_energy=True)
            results[key] = (final.numpy(), energies.numpy())
        elif kind == "train":
            res = parallel.parallel_train_pls(
                mesh(job["mesh"]), PLS(basis, cost), particles=u0,
                number_of_epochs=job["steps"], step_size=job["eta"],
                early_stopper_patience=job["patience"], generator=job.get("seed"),
                fast_path=job["fast_path"], discretisation=job["discretisation"],
                noise=as_t(job.get("noise")))
            results[key] = tuple(np.asarray(t) for t in res)
        elif kind == "predict":
            if job.get("extra_df") is not None:
                basis = basis.replace(
                    additional_predictive_noise_distribution=StudentTPredictiveNoise(
                        df=job["extra_df"], scale=0.1))
            got = PLS(basis, cost).predict_samples(
                u0, torch.as_tensor(job["x_test"]), generator=job["seed"],
                chunk_size=job["chunk"], mesh=mesh(job["mesh"]))
            results[key] = got.numpy()
        else:
            raise ValueError(f"unknown job {kind!r}")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
