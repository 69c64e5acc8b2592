"""The mains' open gaps against the reference's record, settled on the CPU:
the JAX main and the port's main on the same data and the same PLS draws.

One case a process. The JAX main runs at the full configuration with every
PLS draw recorded (``tests/torch_parity.Carrier``: initial particles, every
step's normals, predictive and observation noise); the port's main then runs
on those draws, on the JAX main's data, in the same precision. Only the model
in question runs (``--models pls-onb`` in both mains); no config is edited.

    python3 scripts/carried_gaps.py --case mixture --curve 1 --dtype float64 --out build/gaps
    python3 scripts/carried_gaps.py --case iris --seed 1 --dtype float32 --out build/gaps
    python3 scripts/carried_gaps.py --case curve --main regression --config \
        experiments/curves/regression/config.yaml --curve 1 --out build/gaps

``--case mixture``: ``experiments/curves/mixture_likelihood/config_precond.yaml``
on one curve; the mode split and estimated shift of both runs' particles on
the JAX summarise's predictive noise (``summarise.py``: key 0).
``--case iris``: iris_petal at ``experiments/uci/regression/config_precond_map.yaml``
on one data seed (the CSV is written with ``experiments_torch.uci.fetch_datasets
--sklearn-bundled``); pls-onb's results of both mains. ``--carry_gps`` has
the port's main load the JAX main's exact-GP fits (whose early stop, on a
flat optimum, can fall thousands of epochs apart from the port's).
``--case curve``: one curve main at a given config (the step choices): each
PLS model's chosen step size, steps run and results of both mains;
``--skip_svgp`` leaves the regression main's SVGP out of both (it does not
touch PLS). ``--data port`` runs both mains on the port's own data draw
(host torch generators) instead of the JAX main's; ``--carry_bases`` (fp64)
gives the port's main the JAX main's bases as well, which takes the GP
fits' differences (rtol 1e-8) out of the comparison.

Each model's GP fits are saved under ``--out`` and reloaded by a rerun of the
same case and precision (``--fresh`` fits them again); PLS always trains
anew. Prints one JSON line, also written to ``<out>/<case>-<n>-<dtype>.json``;
for iris it holds both GP fits' loss traces compared (the early stops) and
each step-size candidate's final energies, which ``--report`` prints again
for a case already run, from what it saved under ``--out``.
``--threads`` sets both packages' host threads (default 2), so that several
cases can run side by side.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MIXTURE_CONFIG = "experiments/curves/mixture_likelihood/config_precond.yaml"
IRIS_CONFIG = "experiments/uci/regression/config_precond_map.yaml"


def _setup(dtype: str, threads: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen="
                               f"{'true' if threads > 1 else 'false'} "
                               f"intra_op_parallelism_threads={threads}").strip()
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    torch.set_num_threads(threads)


def _mute_plots(mp, modules, learned):
    """No plots; the learned models' (pls, particles) kept by name."""
    for module in modules:
        for attr in dir(module):
            if attr.startswith(("plot_", "animate_")) and attr != "plot_pls_1d_particles_runner":
                mp.setattr(module, attr, lambda *a, **k: None)
        if hasattr(module, "plot_pls_1d_particles_runner"):
            mp.setattr(module, "plot_pls_1d_particles_runner",
                       lambda pls, particles, particle_name, **k:
                       learned.__setitem__(particle_name, (pls, particles)))
        if hasattr(module, "plot_eigenvalues"):
            mp.setattr(module, "plot_eigenvalues", lambda *a, **k: None)


def _to_port(data, dtype):
    import numpy as np
    import torch

    from experiments_torch.data import Data, ExperimentData, ProblemType

    def part(d):
        if d is None:
            return None
        return Data(**{k: None if getattr(d, k) is None
                       else torch.from_numpy(np.array(getattr(d, k))).to(dtype)
                       for k in ("x", "y", "y_untransformed")}, name=d.name)

    return ExperimentData(name=data.name, problem_type=ProblemType(data.problem_type.value),
                          full=part(data.full), train=part(data.train), test=part(data.test),
                          validation=part(data.validation), y_mean=float(data.y_mean),
                          y_std=float(data.y_std))


def _to_jax(data):
    import jax.numpy as jnp
    import numpy as np

    from experiments.data import Data, ExperimentData, ProblemType

    def part(d):
        if d is None:
            return None
        return Data(**{k: None if getattr(d, k) is None
                       else jnp.asarray(np.asarray(getattr(d, k).cpu()))
                       for k in ("x", "y", "y_untransformed")}, name=d.name)

    return ExperimentData(name=data.name, problem_type=ProblemType(data.problem_type.value),
                          full=part(data.full), train=part(data.train), test=part(data.test),
                          validation=part(data.validation), y_mean=float(data.y_mean),
                          y_std=float(data.y_std))


def _carry_gp_checkpoints(jout, tout):
    """Every exact-GP checkpoint of the JAX main's tree, converted, at the
    same place in the port's: the port's main then loads the JAX main's
    fits instead of fitting its own."""
    from experiments.loaders import load_ard_exact_gp_model as jload
    from experiments_torch.loaders import save_ard_exact_gp_model
    from projected_langevin_sampling_torch import convert
    from tests.torch_parity import exact_gp_params

    for d, _, files in os.walk(jout):
        for f in files:
            if "exact_gp" in f and f.endswith(".pkl"):
                model, losses = jload(os.path.join(d, f))
                target = os.path.join(tout, os.path.relpath(d, jout))
                os.makedirs(target, exist_ok=True)
                save_ard_exact_gp_model(
                    os.path.join(target, f),
                    convert.exact_gp_from_numpy(exact_gp_params(model), device="cpu"),
                    None if losses is None else [float(v) for v in losses])


def _save_energies(carrier, path):
    """Each train_pls call's recorded energies, JAX's and the port's, as
    ``jax_<i>`` and ``port_<i>`` in an npz: where two runs part."""
    import numpy as np

    np.savez(path, **{f"jax_{i}": np.asarray(r["energies"]) for i, r in
                      enumerate(carrier.jax["train"])},
             **{f"port_{i}": np.asarray(r["energies"]) for i, r in
                enumerate(carrier.port_train)})


def _gp_fit_report(jout, tout):
    """The two mains' exact-GP fits side by side, from their checkpoints:
    epochs run, the largest relative difference of the fitted
    hyperparameters, each fit's last five improvements of its running
    minimum loss as (epoch, margin) (the stopper starts its patience again
    on any improvement, however small), the largest gap between the two
    loss traces up to each fit's last improvement, and the first epoch at
    which that gap exceeds the largest of those margins."""
    import pickle

    import numpy as np

    path = ("models", "iris_petal", "subsample_gp", "full_exact_gp_1_of_1.pkl")
    fits = []
    for top in (jout, tout):
        seed_dir, = [d for d in os.listdir(top) if d.isdigit()]
        with open(os.path.join(top, seed_dir, *path), "rb") as f:
            fits.append(pickle.load(f))
    losses = [np.asarray(fit["losses"], dtype=np.float64) for fit in fits]
    improvements = []
    for trace in losses:
        before = np.concatenate([[np.inf], np.minimum.accumulate(trace)[:-1]])
        epochs = np.flatnonzero(trace < before)[1:][-5:]
        improvements.append([[int(e), float(before[e] - trace[e])] for e in epochs])
    n = min(map(len, losses))
    gap = np.abs(losses[0][:n] - losses[1][:n])
    largest_margin = max(m for kept in improvements for _, m in kept)
    hyper = ("lengthscales", "outputscale", "noise", "mean_constant")
    return {
        "epochs": [len(trace) for trace in losses],
        "hyperparameters_max_rel": max(
            float(np.max(np.abs(np.asarray(fits[1][k], dtype=np.float64)
                                - np.asarray(fits[0][k], dtype=np.float64))
                         / np.abs(np.asarray(fits[0][k], dtype=np.float64)))) for k in hyper),
        "last_improvements": dict(zip(("jax", "port"), improvements)),
        "loss_gap_max_to_last_improvement": {
            who: float(gap[:kept[-1][0] + 1].max())
            for who, kept in zip(("jax", "port"), improvements)},
        "first_epoch_gap_above_margins": int(np.argmax(gap > largest_margin))
        if (gap > largest_margin).any() else None}


def _candidate_report(path):
    """Each step-size candidate's final energy in both mains, and the
    relative gap between their energies at steps 1, 10, 100, ... and the
    last: where two runs of the same candidate start apart, and how the gap
    grows with the steps."""
    import numpy as np

    with np.load(path) as saved:
        count = sum(k.startswith("jax_") for k in saved.files)
        runs = [(saved[f"jax_{i}"].astype(np.float64), saved[f"port_{i}"].astype(np.float64))
                for i in range(count)]
    gaps = []
    for j, t in runs:
        n = min(len(j), len(t))
        steps = sorted({10**k for k in range(len(str(n))) if 10**k <= n} | {n})
        gaps.append({s: float(abs(t[s - 1] - j[s - 1]) / abs(j[s - 1])) for s in steps})
    return {"final_energies": {"jax": [float(j[-1]) for j, _ in runs],
                               "port": [float(t[-1]) for _, t in runs]},
            "energy_rel_by_step": gaps}


def iris_report(seed, dtype, work, carry_gps=False):
    """The GP fits and the step-size candidates of an iris case already
    run, from what it saved under ``work``."""
    tag = "-jaxgps" if carry_gps else ""
    energies = os.path.join(work, f"energies{tag}-{dtype}.npz")
    return {"case": "iris_petal", "seed": seed, "dtype": dtype, "carried_gps": carry_gps,
            "gp_fits": _gp_fit_report(os.path.join(work, f"jax-{dtype}"),
                                      os.path.join(work, f"port-{dtype}{tag}")),
            "candidates": _candidate_report(energies) if os.path.exists(energies) else None}


def _steps(runs):
    return [{"step_size": lr, "steps": n} for _, lr, n in runs]


def _csv_values(top):
    """{model/metric_split: value} of every results CSV under ``top``."""
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".csv") and os.path.basename(d).startswith("pls"):
                with open(os.path.join(d, f)) as fh:
                    cell = fh.read().splitlines()[1].split(",")[1]
                out[f"{os.path.basename(d)}/{f[:-4]}"] = float("nan") if cell == "" else float(cell)
    return dict(sorted(out.items()))


def run_curve(main_name, config_path, curve, dtype, work, fresh, skip_svgp=False,
              port_data=False, carry_bases=False):
    import numpy as np
    import pytest
    import torch
    import yaml

    from experiments import plotters as jplotters
    from experiments.curves import common as jcommon
    from experiments.curves.curves import CURVE_FUNCTIONS as JCURVES
    from experiments_torch.config import load_config
    from experiments_torch.curves import common as tcommon
    from experiments_torch.curves.curves import CURVE_FUNCTIONS as TCURVES
    from tests.torch_parity import Carrier, drop_pls_checkpoints

    jmain = __import__(f"experiments.curves.{main_name}.main", fromlist=["main"])
    tmain = __import__(f"experiments_torch.curves.{main_name}.main", fromlist=["main"])
    with open(config_path) as f:
        jconfig = yaml.safe_load(f)
    tconfig = load_config(config_path)
    sections = {k: f"{k}_config" for k in jconfig}
    tdtype = getattr(torch, dtype)
    jout, tout = os.path.join(work, f"jax-{dtype}"), os.path.join(work, f"port-{dtype}")
    for top in (jout, tout):
        if fresh:
            shutil.rmtree(top, ignore_errors=True)
        drop_pls_checkpoints(top)
    carrier, learned, data = Carrier(1e-7 if dtype == "float64" else 1e-2), {}, []
    seconds = {}
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        _mute_plots(mp, (jplotters, jmain, jcommon), learned)
        carrier.record_jax(mp, [jmain, jcommon])
        if main_name == "mixture_likelihood":
            carrier.carry_init_normals(mp, jmain, tmain)
        if carry_bases:
            carrier.carry_bases(mp, jmain, tmain)
        if skip_svgp:
            for module in (jmain, tmain):
                mp.setattr(module, "train_svgp_runner", lambda *a, **k: (None, None, None))
        if port_data:
            def jax_data(**k):
                k["curve_function"] = TCURVES[curve - 1]
                data.append(_to_jax(tmain.get_experiment_data(device="cpu", dtype=tdtype, **k)))
                return data[-1]
        else:
            def jax_data(*a, _fn=jmain.get_experiment_data, **k):
                data.append(_fn(*a, **k))
                return data[-1]
        mp.setattr(jmain, "get_experiment_data", jax_data)
        t0 = time.time()
        jmain.main(curve_function=JCURVES[curve - 1], outputs_path=jout, include_gif=False,
                   **{arg: jconfig[k] for k, arg in sections.items()})
        seconds["jax"] = time.time() - t0
        mp.setattr(tmain, "get_experiment_data", lambda *a, **k: _to_port(data[-1], tdtype))
        carrier.carry_port(mp, [tmain, tcommon])
        for module in (tmain, tcommon):
            carrier.mute(mp, module, "predict_pls_1d_particles_runner")
        t0 = time.time()
        port = tmain.main(curve_function=TCURVES[curve - 1], outputs_path=tout, device="cpu",
                          dtype=tdtype, **{arg: tconfig[k] for k, arg in sections.items()})
        seconds["port"] = time.time() - t0
        carrier.drained()
    _save_energies(carrier, os.path.join(work, f"energies-{dtype}.npz"))
    result = {"main": main_name, "config": config_path, "curve": curve, "dtype": dtype,
              "data": "port" if port_data else "jax", "carried_bases": carry_bases,
              "jax_steps": _steps(carrier.runners["jax"]),
              "port_steps": _steps(carrier.runners["port"]),
              "jax_values": _csv_values(jout), "port_values": _csv_values(tout),
              "seconds": seconds}
    pairs = [(np.asarray(j[0]), np.asarray(t[0].detach().cpu())) for j, t in
             zip(carrier.runners["jax"], carrier.runners["port"])]
    result["particles_max_rel"] = [
        float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300)) for j, t in pairs]
    energies = [(j["energies"], t["energies"]) for j, t in
                zip(carrier.jax["train"], carrier.port_train)]
    result["energies_max_rel"] = [
        float(np.nanmax(np.abs(np.asarray(t) - np.asarray(j)) / np.maximum(np.abs(j), 1e-300)))
        if len(j) == len(t) and j else (None if not j and not t else "lengths differ")
        for j, t in energies]
    if main_name == "mixture_likelihood":
        result.update(_mixture_split(learned, port, data[-1], tdtype))
    return result


def _mixture_split(learned, port, data, tdtype):
    """Both runs' mode split and estimated shift on the JAX summarise's
    predictive noise (its key 0): the record's procedure."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from experiments_torch.curves.mixture_likelihood.summarise import mode_split

    jpls, jparticles = learned["pls-onb-learned"]
    x = jnp.asarray(data.train.x)
    noise = jpls.basis.sample_predictive_noise(particles=jparticles, x=x, key=None)
    y = torch.from_numpy(np.asarray(data.train.y, dtype=np.float64))
    shift = 20.0
    jsplit = mode_split("curve", torch.as_tensor(np.asarray(
        jpls.predict_untransformed_samples(particles=jparticles, x=x, noise=noise),
        dtype=np.float64)), y, shift)
    tsplit = mode_split("curve", port["pls"].predict_untransformed_samples(
        particles=port["particles"], x=torch.from_numpy(np.asarray(x)).to(tdtype),
        noise=torch.from_numpy(np.asarray(noise)).to(tdtype)).double(), y, shift)
    return {"jax_split": jsplit, "port_split": tsplit}


def run_iris(seed, dtype, work, fresh, datasets_dir, carry_gps=False):
    import numpy as np
    import pytest
    import torch
    import yaml

    from experiments import plotters as jplotters
    from experiments.uci.regression import main as jmain
    from experiments_torch.config import load_config
    from experiments_torch.uci.regression import main as tmain
    from tests.torch_parity import Carrier, drop_pls_checkpoints

    with open(IRIS_CONFIG) as f:
        jconfig = yaml.safe_load(f)
    tconfig = load_config(IRIS_CONFIG)
    sections = {k: f"{k}_config" for k in ("kernel", "pls", "svgp", "metrics")}
    sections.update(data="data_config", inducing_points="inducing_points_config")
    jout = os.path.join(work, f"jax-{dtype}")
    tout = os.path.join(work, f"port-{dtype}" + ("-jaxgps" if carry_gps else ""))
    for top in (jout, tout):
        if fresh:
            shutil.rmtree(top, ignore_errors=True)
        drop_pls_checkpoints(top)
    jdata = os.path.join(work, "experiments", "uci", "datasets")
    os.makedirs(jdata, exist_ok=True)
    shutil.copy(os.path.join(datasets_dir, "iris_petal.csv"), jdata)
    carrier, learned = Carrier(1e-7 if dtype == "float64" else 1e-2), {}
    seconds = {}
    log = io.StringIO()
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        _mute_plots(mp, (jplotters, jmain), learned)
        carrier.record_jax(mp, [jmain])
        t0 = time.time()
        try:
            os.chdir(work)  # the JAX main reads experiments/uci/datasets from here
            jmain.main(data_seed=seed, dataset_name="iris_petal", outputs_path=jout,
                       models_filter={"pls-onb"},
                       **{arg: jconfig[k] for k, arg in sections.items()})
        finally:
            os.chdir(cwd)
        seconds["jax"] = time.time() - t0
        if carry_gps:
            _carry_gp_checkpoints(jout, tout)
        carrier.carry_port(mp, [tmain])
        t0 = time.time()
        tmain.main(data_seed=seed, dataset_name="iris_petal", outputs_path=tout,
                   models_filter={"pls-onb"}, datasets_dir=datasets_dir, device="cpu",
                   dtype=getattr(torch, dtype),
                   **{arg: tconfig[k] for k, arg in sections.items()})
        seconds["port"] = time.time() - t0
        carrier.drained()
    tag = "-jaxgps" if carry_gps else ""
    _save_energies(carrier, os.path.join(work, f"energies{tag}-{dtype}.npz"))
    energies = [(j["energies"], t["energies"]) for j, t in
                zip(carrier.jax["train"], carrier.port_train)]
    return {**iris_report(seed, dtype, work, carry_gps),
            "jax_steps": _steps(carrier.runners["jax"]),
            "port_steps": _steps(carrier.runners["port"]),
            "jax_values": _csv_values(os.path.join(jout, str(seed), "results")),
            "port_values": _csv_values(os.path.join(tout, str(seed), "results")),
            "energies_max_rel": [
                float(np.nanmax(np.abs(np.asarray(t) - np.asarray(j))
                                / np.maximum(np.abs(j), 1e-300)))
                if len(j) == len(t) and j else "lengths differ" for j, t in energies],
            "seconds": seconds}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--case", choices=("mixture", "iris", "curve"), required=True)
    parser.add_argument("--curve", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--main", default=None,
                        choices=("regression", "classification", "poisson_regression",
                                 "mixture_likelihood"))
    parser.add_argument("--config", default=None)
    parser.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    parser.add_argument("--out", required=True)
    parser.add_argument("--datasets_dir", default=None,
                        help="iris_petal.csv's directory (fetch_datasets --sklearn-bundled)")
    parser.add_argument("--threads", type=int, default=2)
    parser.add_argument("--fresh", action="store_true", help="fit the GPs again")
    parser.add_argument("--data", choices=("jax", "port"), default="jax",
                        help="--case mixture or curve: whose data draw both mains run on")
    parser.add_argument("--carry_gps", action="store_true",
                        help="--case iris: the port's main loads the JAX main's GP fits")
    parser.add_argument("--carry_bases", action="store_true",
                        help="--case curve, fp64: the port's main takes the JAX main's bases "
                        "too (the GP fits' differences taken out)")
    parser.add_argument("--skip_svgp", action="store_true",
                        help="--case curve: leave the regression main's SVGP out of both")
    parser.add_argument("--report", action="store_true",
                        help="--case iris: print the GP fits and step-size candidates of a "
                        "case already run, from what it saved, and run nothing")
    args = parser.parse_args(argv)
    if args.report:
        work = os.path.abspath(os.path.join(args.out, f"iris-{args.seed}"))
        print(json.dumps(iris_report(args.seed, args.dtype, work, args.carry_gps)))
        return
    _setup(args.dtype, args.threads)
    if args.case == "iris":
        name = f"iris-{args.seed}"
        work = os.path.abspath(os.path.join(args.out, name))
        os.makedirs(work, exist_ok=True)
        result = run_iris(args.seed, args.dtype, work, args.fresh,
                          os.path.abspath(args.datasets_dir), args.carry_gps)
        name += "-jaxgps" if args.carry_gps else ""
    else:
        main_name = "mixture_likelihood" if args.case == "mixture" else args.main
        config = MIXTURE_CONFIG if args.case == "mixture" else args.config
        tag = os.path.splitext(os.path.basename(config))[0]
        name = (f"{main_name}-{tag}-curve{args.curve}"
                + ("-portdata" if args.data == "port" else "")
                + ("-bases" if args.carry_bases else ""))
        work = os.path.abspath(os.path.join(args.out, name))
        os.makedirs(work, exist_ok=True)
        result = run_curve(main_name, config, args.curve, args.dtype, work, args.fresh,
                           args.skip_svgp, args.data == "port", args.carry_bases)
    line = json.dumps(result, default=float)
    with open(os.path.join(args.out, f"{name}-{args.dtype}.json"), "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
