"""The preconditioned mixture main of chip_smoke.py phase 18 on the card,
replayed on the CPU with the card's own draws.

``--record`` runs ``scripts/curve_mains.py``'s ``run_mixture_precond`` on the
card (eager steps, so that each step's draw can be kept) and saves into
``--file``: the exact GP's fitted parameters, and for each ``train_pls`` call
its initial particles, every step's update normals, its final particles and
energies. ``--replay`` runs the same main on the CPU, its exact GP fitted
anew, each call fed the card's normals of that call, and prints the largest
relative differences: what is left is the two devices' arithmetic, the
draws being the same.

  python3 scripts/card_draws_replay.py --record --file chiprun_out/draws.npz
  python3 scripts/card_draws_replay.py --replay --file chiprun_out/draws.npz
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from experiments_torch.curves import common  # noqa: E402
from experiments_torch.curves.mixture_likelihood import main as mixture  # noqa: E402
from projected_langevin_sampling_torch import training  # noqa: E402
from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis  # noqa: E402
from projected_langevin_sampling_torch.utils import early_stopper  # noqa: E402


def run(device, out: str, saved: dict | None):
    """The phase-18 main (PLS seed 0) on ``device`` with every call's draws
    and results kept, in a fresh ``out``; with ``saved``, each call runs on
    the saved normals."""
    shutil.rmtree(out, ignore_errors=True)
    calls, draws, gp = [], [], {}
    sample, loop, learn = (OrthonormalBasis.sample_update_noise, training._train_pls_loop,
                           common.learn_kernel_and_inducing_points)

    def keep_draw(self, n, generator=None, normals=None):
        z = sample(self, n, generator, normals)
        draws[-1].append(z.detach().cpu().numpy())
        return z

    def keep_call(basis, cost, particles, step_size, patience, steps, tier, *args, **kwargs):
        draws.append([])
        if saved is not None:
            kwargs["noise"] = torch.from_numpy(saved[f"draws_{len(calls)}"])
        result = loop(basis, cost, particles, step_size, patience, steps, tier, *args, **kwargs)
        calls.append({"u0": particles, "u": result.particles, "e": result.energies})
        return result

    def keep_gp(**kwargs):
        out_gp = learn(**kwargs)
        _, kernel, likelihood, mean, _, _ = out_gp
        gp.update(lengthscales=kernel.lengthscales.tolist(), outputscale=float(kernel.outputscale),
                  noise=float(likelihood.noise), mean=float(mean))
        return out_gp

    OrthonormalBasis.sample_update_noise = keep_draw
    training._train_pls_loop = keep_call
    mixture.learn_kernel_and_inducing_points = keep_gp
    try:
        with early_stopper._eager_on_card():
            res = runpy.run_path(os.path.join(ROOT, "scripts", "curve_mains.py"))[
                "run_mixture_precond"](out, device, 1, 0)
    finally:
        OrthonormalBasis.sample_update_noise = sample
        training._train_pls_loop = loop
        mixture.learn_kernel_and_inducing_points = learn
    record = {"gp": json.dumps(gp), "result": json.dumps(res)}
    for i, (call, d) in enumerate(zip(calls, draws)):
        record[f"draws_{i}"] = np.stack(d)
        for key in ("u0", "u", "e"):
            record[f"{key}_{i}"] = call[key].detach().cpu().numpy()
    return record


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = parser.add_mutually_exclusive_group(required=True)
    what.add_argument("--record", action="store_true", help="run on the card, save the draws")
    what.add_argument("--replay", action="store_true", help="run on the CPU on the saved draws")
    parser.add_argument("--file", required=True)
    args = parser.parse_args(argv)
    work = os.path.join(ROOT, "build", "draws_replay")
    if args.record:
        record = run("cuda", os.path.join(work, "cuda"), None)
        np.savez(args.file, **record)
        print(json.dumps({"gp": json.loads(record["gp"]), "result": json.loads(record["result"]),
                          "calls": sum(k.startswith("draws_") for k in record)}))
        return
    saved = dict(np.load(args.file))
    record = run("cpu", os.path.join(work, "cpu"), saved)
    rel = lambda a, b: float(np.nanmax(np.abs(a - b)) / np.nanmax(np.abs(b)))  # noqa: E731
    card_gp, cpu_gp = json.loads(str(saved["gp"])), json.loads(record["gp"])
    print(json.dumps({
        "gp_max_rel": max(rel(np.asarray(cpu_gp[k]), np.asarray(card_gp[k])) for k in card_gp),
        "calls": [{key: rel(record[f"{key}_{i}"], saved[f"{key}_{i}"]) for key in ("u0", "u", "e")}
                  for i in range(sum(k.startswith("draws_") for k in saved))],
        "card": json.loads(str(saved["result"])), "cpu": json.loads(record["result"])}))


if __name__ == "__main__":
    main()
