"""The UCI regression main on ``config_parallel.yaml``'s protocol across the
cards of one host, held to the same main in one process.

    python3 scripts/parallel_main_cards.py --ranks 4 --out DIR [--device cpu]

writes the port generator's synthetic ``energy_cooling`` (its real 768
rows) into ``DIR/datasets``, runs the main in one process without
``pls.parallel``, then on a data x particles mesh of ``--ranks`` ranks:
``torchrun --nproc-per-node R`` on the cards (NCCL, one card a rank), or
``launch_cpu_ranks`` with ``--device cpu`` (gloo). The config is
``experiments_torch/uci/regression/config_parallel_2x2_short.yaml`` (the
mesh 2 x 2, cut in depth), with the mesh 2 x (R / 2). Every metric file of
the mesh run must match the single-process run's at rtol 1e-9, the
tolerance the CPU tests hold sharded training to (the column shards'
energies are sums in another order), and only rank 0 may have written.
Every process gets the host's cores over the ranks as its threads. Prints
one JSON line: the files compared, the largest relative difference, each
run's seconds and the cards.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "experiments_torch", "uci", "regression",
                      "config_parallel_2x2_short.yaml")
MESH = ("  parallel:\n    data: 2  # 2 in config_parallel.yaml\n"
        "    particles: 2  # 4 in config_parallel.yaml\n")
RTOL, ROWS = 1e-9, 768


def _files(top: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), top) for d, _, fs in os.walk(top)
                  for f in fs)


def _cells(path: str):
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    return header, [r[0] for r in rows], np.array(
        [[float(c) if c else np.nan for c in r[1:]] for r in rows])


def compare(single: str, mesh: str) -> dict:
    """Every CSV of the mesh run against the single-process run's."""
    files_single, files_mesh = _files(single), _files(mesh)
    if not any(name.endswith(".csv") for name in files_single):
        raise AssertionError(f"no metric file under {single}")
    if files_single != files_mesh:
        raise AssertionError(f"the trees differ: {sorted(set(files_single) ^ set(files_mesh))}")
    worst, compared = 0.0, 0
    for name in files_single:
        if not name.endswith(".csv"):
            continue
        hs, idx_s, vs = _cells(os.path.join(single, name))
        hm, idx_m, vm = _cells(os.path.join(mesh, name))
        if (hs, idx_s) != (hm, idx_m):
            raise AssertionError(f"{name}: header or index differs")
        np.testing.assert_allclose(vm, vs, rtol=RTOL, err_msg=name)
        both = np.isfinite(vs) & np.isfinite(vm)
        if both.any():
            rel = np.abs(vm[both] - vs[both]) / np.maximum(np.abs(vs[both]), 1e-300)
            worst = max(worst, float(rel.max()))
        compared += 1
    return {"files": compared, "max_rel_diff": worst}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", required=True, help="an empty directory for the runs")
    parser.add_argument("--timeout", type=float, default=1200.0)
    args = parser.parse_args()
    n_data, n_particles = 2, args.ranks // 2
    if args.ranks % 2:
        raise SystemExit(f"the mesh is 2 x (ranks / 2): {args.ranks} ranks")
    from experiments_torch.uci import make_synthetic_datasets

    cards = []
    if args.device != "cpu":
        import torch

        if torch.cuda.device_count() < args.ranks:
            print(f"parallel_main_cards: {torch.cuda.device_count()} cards, {args.ranks} ranks "
                  "asked", file=sys.stderr)
            return 1
        cards = [torch.cuda.get_device_name(i) for i in range(args.ranks)]
        from projected_langevin_sampling_torch.ops.cuda import build

        build.build()  # once, before the ranks load the kernels
    # absolute: the main resolves a relative --outputs_dirname against its own directory
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    datasets = os.path.join(args.out, "datasets")
    make_synthetic_datasets.main(ROWS, datasets, names=["energy_cooling"])
    with open(CONFIG) as f:
        text = f.read()
    if text.count(MESH) != 1:
        raise SystemExit(f"{CONFIG}: no 2 x 2 mesh block")
    configs = {"single": text.replace(MESH, ""),
               "mesh": text.replace(MESH, f"  parallel:\n    data: {n_data}\n"
                                          f"    particles: {n_particles}\n")}
    for name, body in configs.items():
        with open(os.path.join(args.out, f"{name}.yaml"), "w") as f:
            f.write(body)
    common = ["--dataset", "energy_cooling", "--data_seed", "0", "--datasets_dir", datasets]
    # every process, the single one too, gets a rank's share of the host's
    # cores as its threads: the host's fp64 factorisations sum in an order
    # that depends on the thread count (on the CPU, 8 threads against 2 moved
    # the train-split metrics by 2e-9)
    threads = os.environ.get("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.ranks)))
    env = dict(os.environ, OMP_NUM_THREADS=threads, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    seconds = {}
    start = time.perf_counter()
    subprocess.run([sys.executable, "-m", "experiments_torch.uci.regression.main",
                    "--config_path", os.path.join(args.out, "single.yaml"), "--outputs_dirname",
                    os.path.join(args.out, "single"), "--device", args.device, *common],
                   check=True, env=env, cwd=ROOT, timeout=args.timeout)
    seconds["single"] = time.perf_counter() - start
    mesh_args = ["--config_path", os.path.join(args.out, "mesh.yaml"), "--outputs_dirname",
                 os.path.join(args.out, "mesh"), *common]
    start = time.perf_counter()
    if args.device == "cpu":
        from experiments_torch.uci.regression import launch_cpu_ranks

        os.environ["OMP_NUM_THREADS"] = threads
        code = launch_cpu_ranks.launch(args.ranks, mesh_args, args.timeout,
                                       log_dir=args.out)
        if code:
            raise SystemExit(f"a CPU rank exited {code}; logs in {args.out}")
    else:
        subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(args.ranks), "-m",
                        "experiments_torch.uci.regression.main", *mesh_args],
                       check=True, env=env, cwd=ROOT, timeout=args.timeout)
    seconds["mesh"] = time.perf_counter() - start
    result = compare(os.path.join(args.out, "single"), os.path.join(args.out, "mesh"))
    print(json.dumps({"ranks": args.ranks, "mesh": [n_data, n_particles], "device": args.device,
                      "cards": cards, "rtol": RTOL, **result, "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
