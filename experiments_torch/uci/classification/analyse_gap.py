"""Post-hoc attribution of the classification PLS-vs-SVGP test-NLL gap
(counterpart of ``experiments/uci/classification/analyse_gap.py``).

For each (dataset, seed) it loads what the port's classification main saved
(splits, subsample-GP kernels, inducing points, the trained particles with
their basis, the SVGP), replaying the main's load path, and measures where
the per-point NLL gap comes from:

  * per-point decomposition: the share of the summed per-point delta
    carried by the worst 5% of test points (a few tail points, or uniform);
  * Monte-Carlo spread of the PLS test NLL over predictive draws
    (generators 0-5; SVGP's marginals are deterministic);
  * confidence and calibration: mean |p - 1/2|, and a validation-fit
    logistic recalibration p -> sigmoid(a logit(p) + b) applied to both
    models;
  * latent moments: the PLS untransformed predictive against the SVGP
    latent, and the PLS variance split into its particle projection and its
    injected noise;
  * a validation-fit spread temper of both models' latents;
  * continued sampling from the checkpoint at its step size (generator 123).

Validation gate: a row counts only if its recomputed test NLLs match what
the main recorded for the same checkpoints, for both models, within
``--tolerance`` nats (default 1e-3). As the JAX script reads them from the
consolidated ``results/uci_metrics_long.csv``, this reads them from the long
CSV ``experiments_torch.make_results_summary`` writes, given as
``--metrics_long`` (the rows of this task, the tree's protocol, the test
split); without one, or for a row that CSV lacks, from the main's own
per-seed ``<seed>/results/<dataset>/<model>/nll_test.csv``, the numbers that
long CSV is made from. The port's checkpoints carry their basis, so they
validate on any device; ``--resave`` upgrades a validated checkpoint that
carries none.

The report goes to ``--report`` and its rows to the CSV beside it, merged
with the rows already there (a (dataset, seed) probed again is replaced).
Runs on the card in fp64 unless asked otherwise.

    python -m experiments_torch.uci.classification.analyse_gap \\
        --outputs_dirname outputs_precond_smooth --report build/gap_attribution.md \\
        [--datasets wine_uci breast_wdbc] [--seeds 0 1 ... 9]
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import pickle

import numpy as np
import torch

from experiments_torch.aggregate_seeds import parse_value, read_metrics_long
from experiments_torch.config import load_config
from experiments_torch.constructors import construct_average_ard_kernel
from experiments_torch.data import ExperimentData, ProblemType
from experiments_torch.loaders import load_inducing_points, load_pls, load_svgp, save_pls
from experiments_torch.runners import dirichlet_exact_gp_runner
from projected_langevin_sampling_torch.models.basis.orthonormal import build_orthonormal_basis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    make_smoothed_bernoulli_cost,
    residual_smoothing_std,
)
from projected_langevin_sampling_torch.models.gaussian_process import BernoulliLikelihood
from projected_langevin_sampling_torch.models.link_functions import SigmoidLinkFunction
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel
from projected_langevin_sampling_torch.training import train_pls

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join("experiments", "uci", "classification", "config_precond_smooth.yaml")
REPORT_COLUMNS = [
    "seed", "pls_nll", "svgp_nll", "delta", "pls_mc_std",
    "pls_nll_recal", "svgp_nll_recal", "tail_share_5pct",
    "pls_conf", "svgp_conf", "pls_latent_var", "pls_proj_var",
    "pls_noise_var", "svgp_latent_var", "pls_nll_extended",
    "pls_proj_var_extended", "pls_nll_temper", "pls_temper_s",
    "svgp_nll_temper", "svgp_temper_s",
]


def load_models(base: str, dataset: str, seed: int, config: dict, device="cuda",
                dtype: torch.dtype = torch.float64):
    """The classification main's load path (no training): returns
    ``(experiment data, PLS, particles, SVGP, best step size, epochs)``."""
    data_path = os.path.join(base, str(seed), "data", dataset)
    models_path = os.path.join(base, str(seed), "models", dataset)
    experiment_data = ExperimentData.load(os.path.join(data_path, "experiment_data.pkl"),
                                          ProblemType.CLASSIFICATION, device=device, dtype=dtype)
    inducing_points = load_inducing_points(os.path.join(data_path, "inducing_points.pkl"),
                                           device)
    kernel_config = config["kernel"]
    d = experiment_data.train.x.shape[1]
    subsample_gp_models = dirichlet_exact_gp_runner(
        experiment_data=experiment_data,
        kernel=ARDKernel(lengthscales=torch.ones(d, dtype=dtype, device=device),
                         outputscale=torch.tensor(1.0, dtype=dtype, device=device)),
        subsample_size=kernel_config["subsample_size"],
        seed=kernel_config["seed"],
        number_of_epochs=kernel_config["number_of_epochs"],
        learning_rate=kernel_config["learning_rate"],
        number_of_iterations=kernel_config["number_of_iterations"],
        early_stopper_patience=kernel_config["early_stopper_patience"],
        model_path=os.path.join(models_path, "subsample_gp"),
        data_path=os.path.join(data_path, "subsample_gp"),
    )
    average_ard_kernel = construct_average_ard_kernel([m.kernel for m in subsample_gp_models])
    pls_config = config["pls"]
    pls_kernel = PLSKernel(base_kernel=average_ard_kernel, approximation_samples=inducing_points.x)
    onb_basis = build_orthonormal_basis(
        kernel=pls_kernel,
        x_induce=inducing_points.x,
        x_train=experiment_data.train.x,
        scaling=pls_config.get("onb_scaling", "reference"),
        relative_eigenvalue_threshold=pls_config.get("onb_relative_eigenvalue_threshold"),
    )
    cost = BernoulliCost(y_train=experiment_data.train.y, link_function=SigmoidLinkFunction())
    if pls_config.get("cost_smoothing") == "residual":
        cost = make_smoothed_bernoulli_cost(
            y_train=experiment_data.train.y,
            smoothing_std=residual_smoothing_std(
                onb_basis, average_ard_kernel(experiment_data.train.x, diag=True)),
        )
    pls = PLS(basis=onb_basis, cost=cost, name="pls-onb")
    # load_pls puts the checkpoint's basis (and its mean constant) on pls
    particles, _, best_lr, n_epochs = load_pls(os.path.join(models_path, "pls-onb.pkl"), pls=pls)
    svgp, _, _ = load_svgp(os.path.join(models_path, "svgp.pkl"),
                           likelihood=BernoulliLikelihood(), device=device)
    return experiment_data, pls, particles, svgp, best_lr, n_epochs


# --- the JAX script's numpy helpers, copied ---------------------------------
def _logit(p: np.ndarray) -> np.ndarray:
    # float64 BEFORE clipping: in float32, 1 - 1e-12 rounds back to 1.0 and
    # log1p(-p) produces -inf
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-12, 1 - 1e-12)
    return np.log(p) - np.log1p(-p)


def _nll(p: np.ndarray, y: np.ndarray) -> float:
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-12, 1 - 1e-12)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log1p(-p)))


def _recalibrate(p_val, y_val, p_tgt):
    """Validation-fit logistic recalibration p -> sigmoid(a*logit(p)+b); grid
    search (the 2-D NLL landscape is smooth and tiny)."""
    zv = _logit(np.asarray(p_val))
    best = (1.0, 0.0, _nll(np.asarray(p_val), np.asarray(y_val)))
    for a in np.geomspace(0.25, 4.0, 33):
        for b in np.linspace(-1.0, 1.0, 21):
            q = 1 / (1 + np.exp(-(a * zv + b)))
            n = _nll(q, np.asarray(y_val))
            if n < best[2]:
                best = (float(a), float(b), n)
    a, b, _ = best
    zt = _logit(np.asarray(p_tgt))
    return 1 / (1 + np.exp(-(a * zt + b))), a, b


_TEMPER_GRID = np.sort(np.append(np.geomspace(0.05, 3.0, 61), 1.0))
_GH32_X, _GH32_W = np.polynomial.hermite.hermgauss(32)


def _temper_pls(f_val, y_val, f_test, y_test):
    """Validation-fit latent spread temper for the particle predictive: each
    latent sample contracted toward the per-point particle mean, f_j ->
    f_bar + s (f_j - f_bar), s chosen on validation (s = 1 is in the grid)."""

    def nll_at(f, y, s):
        fm = f.mean(axis=1, keepdims=True)
        p = 1.0 / (1.0 + np.exp(-(fm + s * (f - fm))))
        return _nll(p.mean(axis=1), y)

    s_best = min(_TEMPER_GRID, key=lambda s: nll_at(f_val, y_val, s))
    return nll_at(f_test, y_test, s_best), float(s_best)


def _temper_svgp(mu_v, var_v, y_v, mu_t, var_t, y_t):
    """Same spread temper for the SVGP latent Gaussian: q(f) = N(mu, s^2
    sigma^2), predictive via 32-node Gauss-Hermite."""

    def nll_at(mu, var, y, s):
        z = mu[:, None] + np.sqrt(2.0 * np.maximum(var, 1e-12))[:, None] * s * _GH32_X[None, :]
        p = (1.0 / (1.0 + np.exp(-z)) * _GH32_W[None, :]).sum(axis=1) / np.sqrt(np.pi)
        return _nll(p, y)

    s_best = min(_TEMPER_GRID, key=lambda s: nll_at(mu_v, var_v, y_v, s))
    return nll_at(mu_t, var_t, y_t, s_best), float(s_best)


def tail_share(pls_probs, svgp_probs, y) -> float:
    """Share of the summed per-point delta (SVGP's log-likelihood minus
    PLS's) carried by the worst 5% of points; NaN where SVGP does not win
    overall."""
    pp = np.clip(np.asarray(pls_probs, dtype=np.float64), 1e-12, 1 - 1e-12)
    ps = np.clip(np.asarray(svgp_probs, dtype=np.float64), 1e-12, 1 - 1e-12)
    lp_p = y * np.log(pp) + (1 - y) * np.log1p(-pp)
    lp_s = y * np.log(ps) + (1 - y) * np.log1p(-ps)
    d = lp_s - lp_p  # >0 where SVGP beats PLS
    k = max(1, int(0.05 * len(d)))
    return float(np.sort(d)[-k:].sum() / d.sum()) if d.sum() > 0 else float("nan")


# ---------------------------------------------------------------------------
def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def analyse(base: str, dataset: str, seed: int, config: dict, device="cuda",
            dtype: torch.dtype = torch.float64) -> tuple[dict, dict]:
    """Returns (probe row, resave context)."""
    experiment_data, pls, particles, svgp, best_lr, n_epochs = load_models(
        base, dataset, seed, config, device, dtype)
    test, val = experiment_data.test, experiment_data.validation
    y = _np(test.y).astype(float)

    pls_probs = _np(pls(x=test.x, particles=particles, generator=0).probs)
    svgp_probs = _np(svgp.predict_y(test.x).probs)
    pls_nll, svgp_nll = _nll(pls_probs, y), _nll(svgp_probs, y)
    mc = [_nll(_np(pls(x=test.x, particles=particles, generator=k).probs), y)
          for k in range(1, 6)]
    out = {
        "dataset": dataset,
        "seed": seed,
        "n_test": len(y),
        "pls_nll": pls_nll,
        "svgp_nll": svgp_nll,
        "delta": pls_nll - svgp_nll,
        "pls_mc_std": float(np.std(mc + [pls_nll])),
        "tail_share_5pct": tail_share(pls_probs, svgp_probs, y),
        "pls_conf": float(np.mean(np.abs(pls_probs - 0.5))),
        "svgp_conf": float(np.mean(np.abs(svgp_probs - 0.5))),
    }
    validation = val is not None and val.x is not None and len(val.y) >= 10
    if validation:
        yv = _np(val.y).astype(float)
        pv = _np(pls(x=val.x, particles=particles, generator=0).probs)
        sv = _np(svgp.predict_y(val.x).probs)
        p_cal, a_p, b_p = _recalibrate(pv, yv, pls_probs)
        s_cal, a_s, b_s = _recalibrate(sv, yv, svgp_probs)
        out.update(pls_nll_recal=_nll(p_cal, y), svgp_nll_recal=_nll(s_cal, y),
                   pls_recal_a=a_p, pls_recal_b=b_p, svgp_recal_a=a_s, svgp_recal_b=b_s)

    # latent moments at the test points; zero injected noise leaves the
    # particle projection k(x, Z) Vt U, the rest of the variance is the noise
    f_samples = _np(pls.predict_untransformed_samples(particles=particles, x=test.x,
                                                      generator=0))
    q_f = svgp.latent(test.x)
    mu_s, var_s = _np(q_f.mean), _np(q_f.variance)
    m_k = pls.basis.approximation_dimension
    n_test, j = test.x.shape[0], f_samples.shape[1]
    zeros = torch.zeros((m_k + n_test, j), dtype=particles.dtype, device=particles.device)
    f_proj = _np(pls.predict_untransformed_samples(particles=particles, x=test.x, noise=zeros))
    proj_var = float(np.mean(np.var(f_proj, axis=1)))
    total_var = float(np.mean(np.var(f_samples, axis=1)))
    out.update(
        pls_latent_var=total_var,
        pls_proj_var=proj_var,
        pls_noise_var=total_var - proj_var,
        svgp_latent_var=float(np.mean(var_s)),
        latent_mean_gap=float(np.mean(np.abs(np.mean(f_samples, axis=1) - mu_s))),
    )
    if validation:
        f_val = _np(pls.predict_untransformed_samples(particles=particles, x=val.x, generator=0))
        pls_t, s_p = _temper_pls(f_val, yv, f_samples, y)
        q_v = svgp.latent(val.x)
        svgp_t, s_s = _temper_svgp(_np(q_v.mean), _np(q_v.variance), yv, mu_s, var_s, y)
        out.update(pls_nll_temper=pls_t, pls_temper_s=s_p, svgp_nll_temper=svgp_t,
                   svgp_temper_s=s_s)

    # continued sampling from the checkpoint at its step size: a spread that
    # contracts and an NLL that drops point at under-convergence
    if best_lr is not None:
        extra = int(np.clip(n_epochs or 1000, 1000, 200_000))
        p2, _ = train_pls(pls, particles, extra, float(best_lr), generator=123,
                          fast_path=config["pls"].get("fast_path", "auto"),
                          discretisation=config["pls"].get("discretisation", "euler"))
        out["pls_nll_extended"] = _nll(_np(pls(x=test.x, particles=p2, generator=0).probs), y)
        f2 = _np(pls.predict_untransformed_samples(particles=p2, x=test.x, noise=zeros))
        out["pls_proj_var_extended"] = float(np.mean(np.var(f2, axis=1)))
        out["extra_steps"] = extra
    resave_ctx = {
        "path": os.path.join(base, str(seed), "models", dataset, "pls-onb.pkl"),
        "pls": pls, "particles": particles, "best_lr": best_lr, "n_epochs": n_epochs,
    }
    return out, resave_ctx


def recorded_nll(base: str, dataset: str, seed: int, model: str,
                 metrics_long: str | None = None) -> float:
    """The test NLL the main recorded for (dataset, seed, model): the long
    CSV's row of the tree's protocol when ``metrics_long`` has one, else the
    main's per-seed file; NaN if neither has it."""
    if metrics_long is not None:
        protocol = os.path.basename(os.path.normpath(base))
        for r in read_metrics_long(metrics_long):
            if r[:7] == ("classification", protocol, "test", dataset, model, "nll", seed):
                return r[7]
    path = os.path.join(base, str(seed), "results", dataset, model, "nll_test.csv")
    if not os.path.exists(path):
        return float("nan")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        if row and row[0] == dataset and row[1] != "":
            return float(row[1])
    return float("nan")


def gate(row: dict, base: str, tolerance: float, metrics_long: str | None = None) -> dict:
    """The row with the recorded NLLs and its ``validated`` flag: both
    recomputed NLLs within ``tolerance`` of the recorded ones (a NaN never
    validates)."""
    for model, key in (("pls-onb", "pls_nll_recorded"), ("svgp", "svgp_nll_recorded")):
        row[key] = recorded_nll(base, row["dataset"], row["seed"], model, metrics_long)
    row["validated"] = bool(abs(row["pls_nll"] - row["pls_nll_recorded"]) <= tolerance
                            and abs(row["svgp_nll"] - row["svgp_nll_recorded"]) <= tolerance)
    return row


# --- the rows' CSV and the report, without pandas ------------------------------
def _cell(value) -> str:
    if isinstance(value, bool):
        return str(value)
    if isinstance(value, float) and math.isnan(value):
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def read_rows(path: str) -> list[dict]:
    """The rows of a report's CSV; none if it is missing or predates the
    gate (no ``validated`` column)."""
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        rows = [{k: parse_value(v) for k, v in r.items()} for r in csv.DictReader(f)]
    return rows if rows and "validated" in rows[0] else []


def merge_rows(prior: list[dict], fresh: list[dict]) -> list[dict]:
    """``prior`` without the (dataset, seed) pairs of ``fresh``, then
    ``fresh``, sorted by (dataset, seed)."""
    probed = {(r["dataset"], r["seed"]) for r in fresh}
    keep = [r for r in prior if (r["dataset"], r["seed"]) not in probed]
    return sorted(keep + fresh, key=lambda r: (r["dataset"], r["seed"]))


def write_rows(path: str, rows: list[dict]) -> None:
    columns = []
    for r in rows:
        columns += [k for k in r if k not in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in rows:
            writer.writerow([_cell(r.get(c, float("nan"))) for c in columns])


def _round(value) -> str:
    if isinstance(value, float):
        return "nan" if math.isnan(value) else f"{round(value, 4):g}"
    return str(value)


def render(rows: list[dict]) -> str:
    lines = [
        "# Classification NLL gap — post-hoc attribution (PyTorch port)\n",
        "Per-seed probes of the classification main's saved models. Columns:"
        " `pls_mc_std` = std of the PLS test NLL over 6 predictive draws;"
        " `*_recal` = test NLL after validation-fit logistic recalibration"
        " (both models); `tail_share_5pct` = share of the summed per-point"
        " delta carried by the worst 5% of test points; `*_latent_var` = mean"
        " predictive variance of the PLS untransformed samples and of the SVGP"
        " latent. Only rows that pass the validation gate count.\n",
    ]
    for dataset in sorted({r["dataset"] for r in rows}):
        sub = [r for r in rows if r["dataset"] == dataset]
        cols = [c for c in REPORT_COLUMNS if any(c in r for r in sub)]
        lines.append(f"## {dataset}\n")
        lines.append("| " + " | ".join(cols) + " |")
        lines.append("|" + "|".join("---:" for _ in cols) + "|")
        for r in sub:
            lines.append("| " + " | ".join(_round(r.get(c, float("nan"))) for c in cols) + " |")
        lines.append("")

        def mean(key, of=sub):
            return float(np.nanmean([r.get(key, float("nan")) for r in of]))

        summary = (f"Means over {len(sub)} seeds: delta {mean('delta'):+.4f}; "
                   f"MC std {mean('pls_mc_std'):.4f}")
        if any("pls_nll_recal" in r for r in sub):
            summary += f"; recalibrated delta {mean('pls_nll_recal') - mean('svgp_nll_recal'):+.4f}"
        tempered = [r for r in sub if math.isfinite(r.get("pls_nll_temper", float("nan")))
                    and math.isfinite(r.get("svgp_nll_temper", float("nan")))]
        if tempered:
            gap = mean("pls_nll_temper", tempered) - mean("svgp_nll_temper", tempered)
            summary += (f"; spread-tempered delta {gap:+.4f}"
                        f" over {len(tempered)} probed seeds"
                        f" (s_pls={mean('pls_temper_s', tempered):.2f},"
                        f" s_svgp={mean('svgp_temper_s', tempered):.2f})")
        summary += (f"; latent var pls/svgp = {mean('pls_latent_var'):.3f}/"
                    f"{mean('svgp_latent_var'):.3f}.")
        lines.append(summary + "\n")
    return "\n".join(lines)


def resave(ctx: dict) -> bool:
    """Rewrite a checkpoint that carries no basis with the basis it was
    validated in; returns whether it wrote."""
    with open(ctx["path"], "rb") as f:
        payload = pickle.load(f)
    if payload.get("basis") is not None:
        return False
    save_pls(path=ctx["path"], particles=ctx["particles"],
             observation_noise=payload.get("observation_noise"), best_lr=ctx["best_lr"],
             number_of_epochs=ctx["n_epochs"], mean_constant=payload.get("mean_constant"),
             basis=ctx["pls"].basis)
    return True


def run(base: str, datasets: list[str], seeds: list[int], config: dict, report: str,
        tolerance: float = 1e-3, do_resave: bool = False, device="cuda",
        dtype: torch.dtype = torch.float64, metrics_long: str | None = None) -> list[dict]:
    """Probe every (dataset, seed) with saved models; the rows (merged with
    the report CSV's earlier rows) go to the CSV after each probe and to the
    report at the end. Returns this run's rows."""
    csv_path = os.path.splitext(report)[0] + ".csv"
    prior = read_rows(csv_path)
    os.makedirs(os.path.dirname(os.path.abspath(report)), exist_ok=True)
    rows = []
    for dataset in datasets:
        for seed in seeds:
            try:
                row, ctx = analyse(base, dataset, seed, config, device, dtype)
            except FileNotFoundError as e:
                print(f"skip {dataset}/{seed}: {e}")
                continue
            gate(row, base, tolerance, metrics_long)
            if not row["validated"]:
                print(f"  [validate] {dataset}/{seed} FAILED: probe pls {row['pls_nll']:.4f} vs "
                      f"recorded {row['pls_nll_recorded']:.4f}, svgp {row['svgp_nll']:.4f} vs "
                      f"{row['svgp_nll_recorded']:.4f}: basis mismatch or stale checkpoint; "
                      "row excluded downstream", flush=True)
            elif do_resave and resave(ctx):
                print(f"  [resave] {ctx['path']} upgraded to the basis-carrying format",
                      flush=True)
            rows.append(row)
            write_rows(csv_path, merge_rows(prior, rows))
            print(f"{dataset}/{seed}: pls={row['pls_nll']:.4f} svgp={row['svgp_nll']:.4f} "
                  f"mc_std={row['pls_mc_std']:.4f} "
                  f"recal={row.get('pls_nll_recal', float('nan')):.4f} "
                  f"latent_var pls/svgp={row['pls_latent_var']:.3f}/{row['svgp_latent_var']:.3f} "
                  f"(proj {row['pls_proj_var']:.3f} + noise {row['pls_noise_var']:.3f}) "
                  f"ext_nll={row.get('pls_nll_extended', float('nan')):.4f} "
                  f"validated={row['validated']}", flush=True)
    if rows:
        with open(report, "w") as f:
            f.write(render(merge_rows(prior, rows)))
        print(f"wrote {report}")
    else:
        print("no artifacts found")
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--datasets", nargs="*", default=["wine_uci", "breast_wdbc"])
    parser.add_argument("--seeds", nargs="*", type=int, default=list(range(10)))
    parser.add_argument("--outputs_dirname", default="outputs_precond_smooth",
                        help="the main's outputs tree under experiments_torch/uci/"
                        "classification (or an absolute path)")
    parser.add_argument("--config_path", default=CONFIG,
                        help="the config the main ran with")
    parser.add_argument("--report", required=True, help="path of the markdown report")
    parser.add_argument("--tolerance", type=float, default=1e-3,
                        help="validation-gate tolerance in nats")
    parser.add_argument("--resave", action="store_true",
                        help="give each validated checkpoint that carries no basis its basis")
    parser.add_argument("--metrics_long", default=None,
                        help="the long CSV make_results_summary wrote (the recorded NLLs)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    args = parser.parse_args(argv)
    rows = run(os.path.join(HERE, args.outputs_dirname), args.datasets, args.seeds,
               load_config(args.config_path), args.report, args.tolerance, args.resave,
               args.device, getattr(torch, args.dtype), args.metrics_long)
    return 0 if rows and all(r["validated"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
