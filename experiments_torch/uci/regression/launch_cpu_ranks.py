"""Run the UCI regression main as several CPU ranks joined by gloo, for a
config with ``pls.parallel`` (``experiments/uci/regression/config_parallel.yaml``
is a 2 x 4 mesh: 8 ranks).

    python -m experiments_torch.uci.regression.launch_cpu_ranks --ranks 8 -- \\
        --config_path experiments/uci/regression/config_parallel.yaml \\
        --dataset energy_cooling --data_seed 0 --datasets_dir DIR --outputs_dirname DIR2

starts one process a rank, each joined through a ``file://`` init method in
a temporary directory (no TCP port), with the host's cores shared out as
its threads, and each running the main's ``cli`` on the arguments after
``--`` with ``--device cpu`` added. Rank 0 writes the outputs. It returns
the largest exit code of the ranks, and ends every rank still running when
one fails or the time limit passes. On cards the launcher is ``torchrun
--nproc-per-node N -m experiments_torch.uci.regression.main ...``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def _rank(rank: int, ranks: int, init: str, argv: list[str]) -> int:
    import torch

    from experiments_torch.uci.regression import main as regression
    from projected_langevin_sampling_torch.parallel import initialize_multi_host

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    initialize_multi_host(init, ranks, rank, device="cpu")
    regression.cli(argv + ["--device", "cpu"])
    return 0


def launch(ranks: int, argv: list[str], timeout: float = 3600.0, log_dir: str | None = None) -> int:
    """Start ``ranks`` processes of the main on ``argv`` and wait for them;
    each rank's output goes to ``<log_dir>/rank<r>.log`` (else this
    process's output)."""
    if "--device" in argv:
        raise ValueError("launch_cpu_ranks runs the ranks on the CPU: leave --device out")
    threads = str(max(1, (os.cpu_count() or 1) // ranks))
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for rank in range(ranks):
            cmd = [sys.executable, "-m", "experiments_torch.uci.regression.launch_cpu_ranks",
                   "--rank", str(rank), "--ranks", str(ranks), "--init", f"file://{tmp}/init",
                   "--", *argv]
            env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", threads),
                       PYTHONPATH=os.pathsep.join(
                           p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
            out = open(os.path.join(log_dir, f"rank{rank}.log"), "w") if log_dir else None
            logs.append(out)
            procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT
                                          if out else None))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
            for out in logs:
                if out:
                    out.close()
    return max(abs(p.returncode) for p in procs)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cut = argv.index("--") if "--" in argv else len(argv)
    own, rest = argv[:cut], argv[cut + 1:]
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--timeout", type=float, default=3600.0,
                        help="seconds before every rank is ended")
    parser.add_argument("--log_dir", default=None, help="a directory for each rank's log")
    parser.add_argument("--rank", type=int)  # set on the processes it starts
    parser.add_argument("--init")
    args = parser.parse_args(own)
    if args.rank is not None:
        return _rank(args.rank, args.ranks, args.init, rest)
    return launch(args.ranks, rest, args.timeout, args.log_dir)


if __name__ == "__main__":
    sys.exit(main())
