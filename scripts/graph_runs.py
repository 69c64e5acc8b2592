"""Each graphed training run against the eager runner, on the same inputs
and generator: the exact GP, the Dirichlet exact GP, the SVGP, the Student-T
and smoothed-Bernoulli ``off`` tiers, a run that stops inside a chunk and one
that stops on a NaN.

A run's graphed form (one step captured into a CUDA graph, replayed in
chunks; ``utils/early_stopper.run_training``) is held to its eager form
(``early_stopper._eager_on_card``, the same step run op by op) bit for bit:
the loss or energy trajectory, the parameters or particles, and the stop.
Each form is timed alone (host clock after a device sync). Its host launch
calls (kernels, graphs, copies and fills) are counted by ``torch.profiler``
on a run of ``PROFILED_STEPS`` steps, all forms in one profiling session,
and carried to the whole run: an eager run's in proportion to its steps, a
graphed run's by one graph launch for each further step (the few calls of
each further chunk's flag read left out). The shapes are the UCI mains' at full width, fp64:
kin8nm's (8192 rows, D = 8; the exact GP on its 5000-row subsample, the SVGP
on M = 81 inducing points with batch 5000, the Student-T tier on the ONB of
those points) and rice's (3810 rows, D = 7; the Dirichlet GP and the
smoothed-Bernoulli tier). Data are made from a seed here.

``chip_smoke.py`` phase 17 calls :func:`hold_all`. Alone, on the card:

  python3 scripts/graph_runs.py [--out chiprun_out/graph_runs.json]

``--device cpu --small`` rehearses the pieces (both forms are eager there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import projected_langevin_sampling_torch as pt  # noqa: E402
from projected_langevin_sampling_torch.utils import early_stopper  # noqa: E402

# kin8nm's and rice's shapes (experiments/uci/make_synthetic_datasets.py),
# split 80/10/10; the UCI configs' J, subsample and batch
KIN8NM = dict(rows=8192, d=8)
RICE = dict(rows=3810, d=7)
SUBSAMPLE, BATCH, PARTICLES = 5000, 5000, 100
# epochs or steps of each run: enough for several chunks of the runner's 256
GP_EPOCHS, SVGP_EPOCHS, OFF_STEPS = 260, 300, 600
# launch calls are counted on runs of this many steps: an eager step makes
# the same calls each time, a graphed one a single graph launch after the
# warm-up step and the capture
PROFILED_STEPS = 32
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def synthetic(rows: int, d: int, seed: int, device, classes: bool = False):
    """experiments/uci/make_synthetic_datasets.py's recipe: correlated
    Gaussian inputs, a sum of 8 RBF bumps plus noise (its sign for labels),
    normalised on the 80% training split. Returns (x_train, y_train)."""
    rng = np.random.default_rng(seed)
    mixing = rng.normal(size=(d, d)) / np.sqrt(d)
    x = rng.normal(size=(rows, d)) @ mixing
    centres = rng.normal(size=(8, d))
    weights = rng.normal(size=8) * 2.0
    f = np.exp(-0.5 * (((x[:, None, :] - centres[None]) / np.sqrt(d)) ** 2).sum(-1)) @ weights
    y = f + 0.1 * np.std(f) * rng.normal(size=rows)
    train = rng.permutation(rows)[: round(0.8 * rows)]
    x, y = x[train], y[train]
    x = (x - x.mean(0)) / x.std(0)
    y = (y > np.median(y)).astype(np.float64) if classes else (y - y.mean()) / y.std()
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return as_t(x), as_t(y)


def same_bits(a, b) -> bool:
    """Bit for bit, NaNs included."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(u, v) for u, v in zip(a, b))
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    if a is None or b is None:
        return a is b
    a, b = a.detach().contiguous(), b.detach().contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int64 if a.element_size() == 8 else torch.int32),
        b.view(torch.int64 if b.element_size() == 8 else torch.int32))


def _ard(d, device):
    return pt.ARDKernel(torch.ones(d, dtype=torch.float64, device=device),
                        torch.tensor(1.0, dtype=torch.float64, device=device))


def _gp_values(out):
    gp, losses = out
    return [losses, gp.mean_constant, gp.kernel.lengthscales, gp.kernel.outputscale, gp.noise]


def _svgp_values(out):
    svgp, losses = out
    if svgp is None:
        return [None, losses]
    ard = svgp.kernel.base_kernel
    return [losses, svgp.mean_constant, ard.lengthscales, ard.outputscale, svgp.likelihood.noise,
            svgp.variational_mean, svgp.variational_chol, svgp.x_induce]


def _pls_values(out):
    particles, energies = out
    return [energies, particles]


def make_runs(device, small: bool = False) -> dict:
    """name -> (run, values, steps): ``run(steps)`` trains from the same
    inputs and generator seed each time for ``steps`` steps (the run's own
    when None); ``values(out)`` lists what must agree."""
    cut = (lambda n: max(n // 8, 40)) if small else (lambda n: n)
    x_k, y_k = synthetic(cut(KIN8NM["rows"]), KIN8NM["d"], 0, device)
    x_r, labels_r = synthetic(cut(RICE["rows"]), RICE["d"], 1, device, classes=True)
    sub = torch.as_tensor(np.random.default_rng(0).permutation(x_k.shape[0])[:cut(SUBSAMPLE)],
                          device=device)
    x_sub, y_sub = x_k[sub], y_k[sub]
    gp_epochs, svgp_epochs, off_steps = (cut(GP_EPOCHS), cut(SVGP_EPOCHS), cut(OFF_STEPS))
    runs = {}

    runs["exact GP"] = (lambda k=gp_epochs: pt.fit_exact_gp(
        x_sub, y_sub, _ard(KIN8NM["d"], device), learning_rate=0.01,
        number_of_epochs=k), _gp_values, gp_epochs)

    targets, noise_var, _ = pt.dirichlet_classification_targets(labels_r.long())
    runs["Dirichlet GP"] = (lambda k=gp_epochs: pt.fit_exact_gp(
        x_r, targets[1].double(), _ard(RICE["d"], device), learning_rate=0.01,
        number_of_epochs=k, fixed_noise_variances=noise_var[1].double()),
        _gp_values, gp_epochs)

    # the SVGP and the Student-T tier on a kernel fitted for 60 epochs
    exact, _ = pt.fit_exact_gp(x_sub, y_sub, _ard(KIN8NM["d"], device), learning_rate=0.05,
                               number_of_epochs=cut(60))
    m = round(math.sqrt(x_k.shape[0]))
    z = x_k[torch.as_tensor(np.random.default_rng(1).permutation(x_k.shape[0])[:m],
                            device=device)]
    kernel = pt.PLSKernel(base_kernel=exact.kernel, approximation_samples=z)
    svgp0 = pt.init_svgp(float(exact.mean_constant), kernel,
                         pt.GaussianLikelihood(noise=exact.noise), z)
    runs["SVGP"] = (lambda k=svgp_epochs: pt.fit_svgp(
        svgp0, x_k, y_k, k, min(BATCH, x_k.shape[0] * 3 // 4), 0.01,
        learn_inducing_locations=True, generator=0), _svgp_values, svgp_epochs)

    basis = pt.build_orthonormal_basis(kernel, z, x_k, verbose=False, scaling="nystrom",
                                       relative_eigenvalue_threshold=1e-5)
    student = pt.PLS(basis, pt.StudentTCost(y_train=y_k, degrees_of_freedom=4.0, scale=0.1))
    u_k = student.initialise_particles(PARTICLES, generator=0)
    runs["Student-T off"] = (lambda k=off_steps: pt.train_pls(
        student, u_k, k, 1e-3, generator=3, fast_path="off",
        discretisation="preconditioned"), _pls_values, off_steps)

    m_r = round(math.sqrt(x_r.shape[0]))
    z_r = x_r[torch.as_tensor(np.random.default_rng(2).permutation(x_r.shape[0])[:m_r],
                              device=device)]
    basis_r = pt.build_orthonormal_basis(
        pt.PLSKernel(base_kernel=_ard(RICE["d"], device), approximation_samples=z_r), z_r, x_r,
        verbose=False, scaling="nystrom", relative_eigenvalue_threshold=1e-5)
    smooth = pt.PLS(basis_r, pt.make_smoothed_bernoulli_cost(
        labels_r, 0.5 * torch.ones_like(labels_r)))
    u_r = smooth.initialise_particles(PARTICLES, generator=0)
    runs["smoothed-Bernoulli off"] = (lambda k=cut(OFF_STEPS // 2): pt.train_pls(
        smooth, u_r, k, 1e-3, generator=4, fast_path="off",
        discretisation="preconditioned"), _pls_values, cut(OFF_STEPS // 2))

    # a step of 0.8 with no patience stops at the first epoch without
    # improvement, a few epochs in: inside the first chunk (rice's first
    # 1000 rows: the rest of the chunk's epochs still run, frozen)
    runs["stop inside a chunk"] = (lambda k=gp_epochs: pt.fit_exact_gp(
        x_r[:1000], targets[1, :1000].double(), _ard(RICE["d"], device), learning_rate=0.8,
        number_of_epochs=k, early_stopper_patience=0.0), _gp_values, gp_epochs)

    # an Euler step far past the stability bound overflows to inf, then NaN
    euler = pt.PLS(basis, pt.GaussianCost(y_train=y_k, observation_noise=exact.noise))
    runs["stop on a NaN"] = (lambda k=off_steps: pt.train_pls(
        euler, u_k, k, 10.0, generator=5, fast_path="off"), _pls_values, off_steps)
    return runs


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _launch_counts(jobs: dict) -> dict:
    """Host launch calls of each ``jobs[label]()``, from the runtime events
    the profiler records inside its ``record_function`` range; one session
    for all (None where the profiler saw no launch at all)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label, fn in jobs.items():
            with record_function(f"graph_runs/{label}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name[len("graph_runs/"):]: e.time_range for e in events
              if e.name.startswith("graph_runs/")}
    starts = [e.time_range.start for e in events if e.name in LAUNCH_NAMES]
    if not starts:
        return {label: None for label in jobs}
    return {label: sum(r.start <= t <= r.end for t in starts) for label, r in ranges.items()}


def hold(name, run, values, steps, device, log=print) -> dict:
    """Run ``run`` eagerly, then graphed; compare every value bit for bit;
    return the times, syncs and B2 counts of both forms."""
    res = {"name": name, "steps": steps}
    outs = {}
    for mode in ("eager", "graph"):
        ctx = early_stopper._eager_on_card() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            before = [getattr(o, a) for o, a in early_stopper.REPLAYED_COUNTERS]
            out, seconds = _timed(run, device)
            stats = early_stopper.last_run_stats
            counted = [getattr(o, a) - b
                       for (o, a), b in zip(early_stopper.REPLAYED_COUNTERS, before)]
        outs[mode] = values(out)
        taken = len(outs[mode][0]) if outs[mode][0] is not None else None
        res[mode] = {"ms_per_step": 1e3 * seconds / stats.steps, "seconds": seconds,
                     "host_syncs": stats.host_syncs, "captures": stats.captures,
                     "mode": stats.mode, "steps_launched": stats.steps, "launches": None,
                     "recorded": taken, "counters": counted}
    res["bitwise"] = same_bits(outs["eager"], outs["graph"])
    # B2's launches and backward passes: a replay counts what its capture ran
    res["counters_agree"] = res["eager"]["counters"] == res["graph"]["counters"]
    return res


def count_launches(runs: dict, results: list[dict]) -> None:
    """Fill in each result's launch calls a run (see the module's note)."""
    jobs = {}
    for r in results:
        run, short = runs[r["name"]][0], min(PROFILED_STEPS, r["steps"])
        jobs[f"{r['name']}/graph"] = lambda run=run, k=short: run(k)

        def eager(run=run, k=short):
            with early_stopper._eager_on_card():
                run(k)

        jobs[f"{r['name']}/eager"] = eager
    counts = _launch_counts(jobs)
    for r in results:
        short = min(PROFILED_STEPS, r["steps"])
        e, g = counts[f"{r['name']}/eager"], counts[f"{r['name']}/graph"]
        if e is not None:
            r["eager"]["launches"] = round(e * r["eager"]["steps_launched"] / short)
        if g is not None:
            r["graph"]["launches"] = g + r["graph"]["steps_launched"] - short


def report(r: dict, log=print) -> None:
    e, g = r["eager"], r["graph"]
    log(f"  {r['name']}: {r['steps']} steps, recorded {g['recorded']}; eager "
        f"{e['ms_per_step']:.4f} ms/step, {e['host_syncs']} host syncs, {e['launches']} "
        f"launch calls; graph {g['ms_per_step']:.4f} ms/step, {g['host_syncs']} host syncs, "
        f"{g['launches']} launch calls, {g['captures']} capture(s) ({g['mode']}); B2 launches "
        f"and backward passes {e['counters']} eager, {g['counters']} graph; bit for bit: "
        f"{r['bitwise']}")


def hold_all(device, small: bool = False, log=print, keep_going: bool = False) -> list[dict]:
    """Every run of :func:`make_runs` held both ways, then their launch
    calls counted; ``keep_going`` logs a run that raises and goes on."""
    device = torch.device(device)
    runs = make_runs(device, small)
    results = []
    for name, (run, values, steps) in runs.items():
        try:
            results.append(hold(name, run, values, steps, device, log))
        except Exception as exc:
            if not keep_going:
                raise
            log(f"  {name}: FAILED {type(exc).__name__}: {exc}")
    if device.type == "cuda":
        count_launches(runs, results)
    for r in results:
        report(r, log)
    if len(results) < len(runs):
        results.append({"name": "failed runs", "bitwise": False})
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--small", action="store_true", help="an eighth of the rows and steps")
    parser.add_argument("--out", type=str, default=None, help="write the results as JSON here")
    args = parser.parse_args()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    results = hold_all(args.device, args.small, keep_going=True)
    print(json.dumps({"seconds": time.perf_counter() - t0, "runs": results}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if not all(r["bitwise"] for r in results):
        raise SystemExit("a graphed run differs from its eager form")


if __name__ == "__main__":
    main()
