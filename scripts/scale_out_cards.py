"""Drive the port's scale-out (``projected_langevin_sampling_torch/parallel``)
across the cards of one host, hold it to the single-card calls, and time it.

    python3 scripts/scale_out_cards.py [--ranks 4] [--device cpu] [--small]

starts one process a rank (NCCL, one card each; gloo with ``--device
cpu``), joined through a ``file://`` init method in a temporary directory,
after building the kernels once. Every rank builds the same models from
seeds at bench.py's headline shape (N=5000, M=512, J=1000, fp32, step 1e-4;
``--small`` cuts it for a rehearsal on the CPU) and runs:

  (a) 20 injected-noise steps of ``parallel_langevin_steps_with_noise`` on
      the IPB Bernoulli cell on meshes 1xR, 2x(R/2) and Rx1, against
      ``langevin_steps`` on its own card (B5 fused, or B5's partial mode and
      an all-reduce over "data");
  (b) 2000 seeded steps of ``parallel_langevin_steps`` on each mesh, timed
      against ``langevin_steps`` on one card;
  (c) ``parallel_train_pls`` on 1xR against ``train_pls`` on one card: the
      ONB Gaussian auto tier (B1, 20,000 steps), the smoothed Bernoulli
      preconditioned cell with its MAP mean (B3, 2000 steps at chip_smoke
      phase 7's converging step 1e-2, where a patience can stop) and the IPB
      Gaussian quadratic_fused tier (B4, 20,000 steps), each with infinite
      patience (timed) and with a patience whose stop falls inside the run;
  (d) ``predict_samples(mesh=)`` on 1xR at N*=4096 in chunks of 256 against
      the single-card chunked call, timed.

Times are host clock around work that ends in a synchronise, the slowest
rank's, after one untimed call and a barrier. Each rank gets the host's cores over the ranks as
its ``OMP_NUM_THREADS`` unless the caller sets it. Rank 0 prints one JSON line; any disagreement
raises. The tolerances and their reasons are beside them below.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = dict(n=5000, m=512, j=1000, test=4096, chunk=256, steps_b1=20_000, steps=2000)
SMALL = dict(n=400, m=64, j=80, test=256, chunk=32, steps_b1=2000, steps=300)
ETA, T_NOISE = 1e-4, 20
# (a) 20 fp32 steps with the sums over N or the split-K slices in another
# order: phase 9's 1e-5 a step, normwise, with room for 20 steps
TOL_STEPS = 1e-4
# (c) B3 and B4 on shards against one card: the same draws, products over
# other split-K slices (chip_smoke phase 6's W_TOL, normwise); energies fp32
# sums in another order (phase 6's E_RTOL). B1 is elementwise, bit for bit
# on W (chip_smoke phase 12 (c)); U = q_out W and W0 = q_in^T U0 are fp32
# products of depth M over fewer columns, which cuBLAS may sum in another
# order: 2 M 2^-24 = 6e-5 for M = 512, normwise.
W_TOL, E_RTOL, B1_TOL = 1e-3, 1e-5, 1e-4
# (d) the same normals, each block's factorisation on another card
TOL_PREDICT = 1e-5
# (c) the finite patience, in steps: the first whose stop, replayed on the
# one-card run's energies, falls inside the run
PATIENCE_STEPS = (1, 3, 10, 30, 100, 300)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _models(pt, shape, device):
    """bench.py's build() at ``shape``: sorted X on [-3, 3], y = sin(2x) +
    0.2 noise, Z = linspace, lengthscale 0.01; the ONB and the IPB (y(Z) =
    sin(2Z)); labels and smoothing stds of the classification cell."""
    rng = np.random.default_rng(0)
    n, m = shape["n"], shape["m"]
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0)
    y = np.sin(2 * x[:, 0]) + 0.2 * rng.normal(size=n)
    labels = (np.sin(2 * x[:, 0]) + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    std = rng.uniform(0.3, 1.2, n)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    x, y, labels, std = (as_t(a) for a in (x, y, labels, std))
    z = torch.linspace(-3, 3, m, device=device)[:, None]
    kernel = pt.PLSKernel(base_kernel=pt.ARDKernel(lengthscales=as_t([0.01]),
                                                   outputscale=as_t(1.0)),
                          approximation_samples=x)
    onb = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    ipb = pt.build_inducing_point_basis(kernel, z, torch.sin(2 * z[:, 0]), x)
    gauss = pt.GaussianCost(y_train=y, observation_noise=as_t(0.1))
    smoothed = pt.make_smoothed_bernoulli_cost(labels, std)
    m0 = pt.fit_mean_constant_map(onb, smoothed)
    return {"onb": pt.PLS(onb, gauss), "ipb": pt.PLS(ipb, gauss),
            "ipb_bern": pt.PLS(ipb, pt.BernoulliCost(y_train=labels)),
            "smoothed": pt.PLS(onb.replace(mean_constant=m0), smoothed)}


def _rank(args) -> int:
    import torch.distributed as dist

    import projected_langevin_sampling_torch as pt
    from projected_langevin_sampling_torch.ops.cuda import fused_update
    from projected_langevin_sampling_torch.utils.early_stopper import replay_early_stopper

    shape = SMALL if args.small else FULL
    rank, world = pt.initialize_multi_host(args.init, args.ranks, args.rank, device=args.device)
    on_card = args.device != "cpu"
    device = torch.device(f"cuda:{torch.cuda.current_device()}" if on_card else "cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed(fn):
        """(fn(), the slowest rank's seconds), after one untimed call that
        pays the first call's costs (cuBLAS plans of new shapes, the host
        LAPACK's threads, NCCL's communicators)."""
        fn()
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        elapsed = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=device)
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
        return out, float(elapsed)

    def normwise(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    models = _models(pt, shape, device)
    j, steps = shape["j"], shape["steps"]
    meshes = {f"{a}x{b}": pt.make_mesh(a, b, device=args.device)
              for a, b in ((1, world), (2, world // 2), (world, 1))}
    out = {"ranks": world, "device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "host_threads": torch.get_num_threads(), "shape": shape}

    # (a), (b): B5 under parallel_langevin_steps
    ipb_bern = models["ipb_bern"]
    basis, cost = ipb_bern.basis, ipb_bern.cost
    u0 = basis.initialise_particles(j, generator=0)
    gen_z = torch.Generator(device=device).manual_seed(12)
    normals = torch.randn((T_NOISE, shape["m"], j), generator=gen_z, device=device)
    update_noise = torch.stack([basis.sample_update_noise(j, normals=z) for z in normals])
    want = pt.langevin_steps(basis, cost, u0, 0, ETA, T_NOISE, fast_path="off", noise=normals)
    _, single_s = timed(lambda: pt.langevin_steps(basis, cost, u0, 0, ETA, steps,
                                                  fast_path="off"))
    out["langevin_steps_ms_per_step"] = 1e3 * single_s / steps
    for name, mesh in meshes.items():
        fused_update.fused_update.launches = fused_update.fused_drift.launches = 0
        got = pt.parallel_langevin_steps_with_noise(mesh, basis, cost, u0, update_noise, ETA)
        err = normwise(got, want)
        require(err <= TOL_STEPS, f"(a) {name}: {err}")
        launches = (fused_update.fused_update.launches, fused_update.fused_drift.launches)
        (stepped, _), mesh_s = timed(lambda: pt.parallel_langevin_steps(
            mesh, basis, cost, u0, 0, ETA, steps))
        require(bool(torch.isfinite(stepped).all()), f"(b) {name} particles")
        out[f"steps_{name}"] = {"max_rel_err": err, "launches_fused_partial": launches,
                                "ms_per_step": 1e3 * mesh_s / steps}

    # (c): parallel_train_pls on 1xR against train_pls on one card
    mesh = meshes[f"1x{world}"]
    cells = (("B1", "onb", dict(), shape["steps_b1"], ETA),
             ("B3", "smoothed", dict(fast_path="general_fused", discretisation="preconditioned"),
              steps, 1e-2),
             ("B4", "ipb", dict(fast_path="quadratic_fused"), shape["steps_b1"], ETA))
    for label, model, kw, t, eta in cells:
        pls = models[model]
        u0 = pls.initialise_particles(j, generator=0)
        res, par_s = timed(lambda: pt.parallel_train_pls(
            mesh, pls, particles=u0, number_of_epochs=t, step_size=eta, generator=0, **kw))
        (want_u, want_e), one_s = timed(lambda: pt.train_pls(
            pls, u0, t, eta, generator=0, **kw))
        e_err = float(((res.energies - torch.as_tensor(want_e, device=device)).abs()
                       / torch.as_tensor(want_e, device=device).abs()).max())
        w_err = normwise(res.particles, want_u)
        bitwise = bool(torch.equal(res.particles, want_u))
        tol = B1_TOL if label == "B1" else W_TOL
        require(w_err <= tol and e_err <= E_RTOL,
                f"(c) {label}: particles {w_err} (bit for bit {bitwise}), energies {e_err}")
        trace = torch.as_tensor(want_e, dtype=torch.float64)
        # half a step below k steps: no stopper decides on a tie
        stops = {(k - 0.5) * eta: int(replay_early_stopper(trace, eta, (k - 0.5) * eta)[1])
                 for k in PATIENCE_STEPS}
        patience = next((p for p, s in stops.items() if 10 <= s <= t - 10), None)
        require(patience is not None, f"(c) {label}: no patience stops inside: {stops}")
        res_p = pt.parallel_train_pls(mesh, pls, particles=u0, number_of_epochs=t,
                                      step_size=eta, early_stopper_patience=patience,
                                      generator=0, **kw)
        want_pu, want_pe = pt.train_pls(pls, u0, t, eta, early_stopper_patience=patience,
                                        generator=0, **kw)
        stop_err = normwise(res_p.particles, want_pu)
        require(int(res_p.steps_run) == len(want_pe) + 1 and stop_err <= tol,
                f"(c) {label} patience {patience}: stop {int(res_p.steps_run)} against "
                f"{len(want_pe) + 1}, particles {stop_err}")
        out[f"train_{label}"] = {
            "steps": t, "ms_per_step": 1e3 * par_s / t, "one_card_ms_per_step": 1e3 * one_s / t,
            "max_rel_err": w_err, "bit_for_bit": bitwise, "energy_max_rel_err": e_err,
            "patience": patience, "stop": int(res_p.steps_run), "stop_max_rel_err": stop_err}

    # (d): mesh-sharded chunked serving
    pls = models["onb"]
    particles = pls.initialise_particles(j, generator=0)
    x_test = torch.linspace(-3, 3, shape["test"], device=device)[:, None]
    samples, mesh_s = timed(lambda: pls.predict_samples(
        particles, x_test, generator=0, chunk_size=shape["chunk"], mesh=mesh))
    single, one_s = timed(lambda: pls.predict_samples(
        particles, x_test, generator=0, chunk_size=shape["chunk"]))
    err = normwise(samples, single)
    require(err <= TOL_PREDICT, f"(d) predict: {err}")
    out["predict"] = {"ms": 1e3 * mesh_s, "one_card_ms": 1e3 * one_s, "max_rel_err": err,
                      "bit_for_bit": bool(torch.equal(samples, single))}
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--rank", type=int)  # set on the processes it starts
    parser.add_argument("--init")
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    if args.rank is not None:
        return _rank(args)
    if args.device != "cpu":
        if torch.cuda.device_count() < args.ranks:
            print(f"scale_out_cards: {torch.cuda.device_count()} cards, {args.ranks} ranks asked",
                  file=sys.stderr)
            return 1
        from projected_langevin_sampling_torch.ops.cuda import build

        build.build()  # once, before the ranks load them
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(args.ranks):
            cmd = [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--ranks",
                   str(args.ranks), "--device", args.device, "--init", f"file://{tmp}/init"]
            # each rank's host threads (BLAS, OpenMP): the host's cores shared
            # out, as a launcher sets them; unset, every rank takes them all
            env = dict(os.environ, LOCAL_RANK=str(rank))
            env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.ranks)))
            procs.append(subprocess.Popen(cmd + (["--small"] if args.small else []), env=env))
        try:
            codes = [proc.wait(timeout=1200) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
