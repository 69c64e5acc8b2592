"""Audit of the SVGP regression baseline (counterpart of
``experiments/audit_svgp.py``): the port's SVGP trainer, as the UCI sweep
runs it (``runners.train_svgp_runner``: SGD on the ELBO with the grams on
B2, the likelihood noise always learned), against a plain-torch rebuild of
the reference's gpytorch SVGP protocol, on identical inputs.

The rebuild (:func:`train_torch_svgp`, :func:`torch_svgp_metrics`) is the JAX
script's own plain-torch code, copied: a whitened Cholesky variational
distribution q(u) = N(L v, L S L^T) with L = chol(K_zz + 1e-8 I); the noise
through a softplus with gpytorch's GreaterThan(1e-4) constraint, started at
the harness's averaged subsample-GP noise; a learned constant mean; the
PLS r-kernel fixed; plain full-batch SGD on the per-point negative ELBO;
the early stopper with its patience in accumulated learning-rate units; a
log-spaced learning-rate grid, best by final loss.

Both trainers get the inputs the UCI regression main makes (:func:`setup`:
the split, the averaged ARD kernel, the inducing points, the noise and mean
initialisation), cached under ``--outputs_dirname`` with the sweep's
train-or-load keying; when that tree holds the sweep's own ``svgp.pkl`` the
audit loads it instead of training. Runs on the card in fp64 (the rebuild
too) unless asked otherwise. The report goes to ``--out``.

    python -m experiments_torch.audit_svgp --datasets boston,energy_cooling,wine_quality \\
        --seeds 0,1,2 --datasets_dir DIR --out build/audit_svgp.md
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from experiments_torch.config import load_config
from experiments_torch.constructors import (
    construct_average_ard_kernel,
    construct_average_gaussian_likelihood_from_models,
    construct_average_mean_constant,
)
from experiments_torch.data import ExperimentData, ProblemType
from experiments_torch.loaders import load_inducing_points, load_svgp, save_inducing_points
from experiments_torch.metrics import calculate_mse, calculate_nll
from experiments_torch.runners import exact_gp_runner, inducing_points_runner, train_svgp_runner
from experiments_torch.uci.regression.main import DATASETS_DIR, get_experiment_data
from projected_langevin_sampling_torch.models.gaussian_process import GaussianLikelihood
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (  # noqa: E501
    ConditionalVarianceInducingPointSelector,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel


def setup(dataset_name: str, seed: int, cfg: dict, outputs_path: str,
          datasets_dir: str = DATASETS_DIR, device="cuda", dtype: torch.dtype = torch.float64):
    """The UCI regression main's data -> kernel -> inducing points, cached
    under ``outputs_path``; returns ``(experiment data, inducing points, PLS
    kernel, noise0, mean0)``."""
    data_path = os.path.join(outputs_path, str(seed), "data", dataset_name)
    models_path = os.path.join(outputs_path, str(seed), "models", dataset_name)
    for p in (data_path, models_path):
        os.makedirs(p, exist_ok=True)
    experiment_data_path = os.path.join(data_path, "experiment_data.pkl")
    if os.path.exists(experiment_data_path):
        experiment_data = ExperimentData.load(experiment_data_path, ProblemType.REGRESSION,
                                              device=device, dtype=dtype)
    else:
        experiment_data = get_experiment_data(
            seed=seed,
            train_data_percentage=cfg["data"]["train_data_percentage"],
            validation_data_percentage=cfg["data"]["validation_data_percentage"],
            dataset_name=dataset_name,
            datasets_dir=datasets_dir,
            device=device,
            dtype=dtype,
        )
        experiment_data.save(experiment_data_path)

    kernel_config = cfg["kernel"]
    d = experiment_data.train.x.shape[1]
    subsample_gp_models = exact_gp_runner(
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
    likelihood = construct_average_gaussian_likelihood_from_models(subsample_gp_models)
    mean_constant = construct_average_mean_constant(subsample_gp_models)

    inducing_points_path = os.path.join(data_path, "inducing_points.pkl")
    if os.path.exists(inducing_points_path):
        inducing_points = load_inducing_points(inducing_points_path, device)
    else:
        ip_cfg = cfg["inducing_points"]
        inducing_points = inducing_points_runner(
            seed=ip_cfg["seed"],
            inducing_point_selector=ConditionalVarianceInducingPointSelector(),
            data=experiment_data.train,
            number_induce_points=int(
                ip_cfg["inducing_points_factor"]
                * math.pow(experiment_data.train.x.shape[0], 1 / ip_cfg["inducing_points_power"])
            ),
            kernel=average_ard_kernel,
        )
        save_inducing_points(inducing_points_path, inducing_points)
    pls_kernel = PLSKernel(base_kernel=average_ard_kernel, approximation_samples=inducing_points.x)
    return (experiment_data, inducing_points, pls_kernel, float(likelihood.noise),
            float(mean_constant))


# ---------------------------------------------------------------------------
# The plain-torch rebuild of the gpytorch protocol (the JAX script's, copied;
# ``device`` added)
# ---------------------------------------------------------------------------
def train_torch_svgp(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_induce: np.ndarray,
    lengthscales: np.ndarray,
    outputscale: float,
    noise_init: float,
    mean_init: float,
    number_of_epochs: int,
    batch_size: int,
    learning_rate: float,
    early_stopper_patience: float,
    seed: int,
    device=None,
):
    """One LR candidate: SGD on the per-point negative ELBO. Returns
    (params dict or None, losses)."""
    torch.manual_seed(seed)
    dtype = torch.float64
    x = torch.as_tensor(x_train, dtype=dtype, device=device)
    y = torch.as_tensor(y_train, dtype=dtype, device=device)
    z = torch.as_tensor(x_induce, dtype=dtype, device=device)
    ls = torch.as_tensor(lengthscales, dtype=dtype, device=device)
    n, m = x.shape[0], z.shape[0]
    eye = torch.eye(m, dtype=dtype, device=device)

    def ard(x1, x2):
        a, b = x1 / ls, x2 / ls
        d2 = (a.square().sum(-1)[:, None] + b.square().sum(-1)[None, :]
              - 2.0 * a @ b.T).clamp_min(0.0)
        return outputscale * torch.exp(-0.5 * d2)

    def r_kernel(x1, x2):
        return ard(x1, z) @ ard(z, x2.reshape(-1, z.shape[1])).T / m

    k_zz = r_kernel(z, z)
    # gpytorch psd_safe_cholesky jitter ladder starts at 1e-8 in fp64
    chol = torch.linalg.cholesky(k_zz + 1e-8 * eye)
    k_xx_diag = ard(x, z).square().sum(-1) / m  # r(x,x) diag = |k(x,Z)|^2/M

    # parameters: whitened variational mean/chol, raw noise (softplus,
    # GreaterThan(1e-4) like gpytorch), constant mean
    v_mean = torch.zeros(m, dtype=dtype, device=device, requires_grad=True)
    v_chol = eye.clone().requires_grad_(True)
    inv_softplus = math.log(math.expm1(max(noise_init - 1e-4, 1e-12)))
    raw_noise = torch.tensor(inv_softplus, dtype=dtype, device=device, requires_grad=True)
    mean_c = torch.tensor(mean_init, dtype=dtype, device=device, requires_grad=True)

    opt = torch.optim.SGD([v_mean, v_chol, raw_noise, mean_c], lr=learning_rate)

    k_xz = ard(x, z) @ ard(z, z).T / m  # r(x, Z)
    a_full = torch.linalg.solve_triangular(chol, k_xz.T, upper=False).T  # (N, M)

    def neg_elbo():
        noise = torch.nn.functional.softplus(raw_noise) + 1e-4
        c = torch.tril(v_chol)
        mean_f = mean_c + a_full @ v_mean
        ac = a_full @ c
        var_f = (k_xx_diag - a_full.square().sum(-1) + ac.square().sum(-1)).clamp_min(0.0)
        ell = (-0.5 * math.log(2 * math.pi) - 0.5 * noise.log()
               - 0.5 * (y - mean_f).square() / noise - 0.5 * var_f / noise)
        diag = c.diagonal()
        kl = 0.5 * (c.square().sum() + v_mean @ v_mean - m
                    - 2.0 * diag.abs().log().sum())
        return -(ell.sum() - kl) / n

    losses = []
    min_loss, sim_time = float("inf"), 0.0
    for _ in range(number_of_epochs):
        opt.zero_grad()
        loss = neg_elbo()
        loss.backward()
        opt.step()
        loss_val = float(neg_elbo().detach())
        if not math.isfinite(loss_val):
            return None, None
        if loss_val < min_loss:
            min_loss, sim_time = loss_val, 0.0
        else:
            sim_time += learning_rate
            if sim_time >= early_stopper_patience:
                break
        losses.append(loss_val)

    noise = float(torch.nn.functional.softplus(raw_noise).detach()) + 1e-4
    with torch.no_grad():
        params = {
            "v_mean": v_mean.detach().cpu().numpy(),
            "v_chol": torch.tril(v_chol).detach().cpu().numpy(),
            "noise": noise,
            "mean_constant": float(mean_c.detach()),
            "chol_kzz": chol.cpu().numpy(),
        }
    return params, losses


def torch_svgp_metrics(params, x_eval, y_eval, x_induce, lengthscales, outputscale,
                       device=None):
    """Predictive test metrics for the torch SVGP — the harness's Gaussian
    marginal-NLL convention (metrics.py::calculate_nll)."""
    dtype = torch.float64
    tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    x, y, z, ls = tensor(x_eval), tensor(y_eval), tensor(x_induce), tensor(lengthscales)
    m = z.shape[0]

    def ard(x1, x2):
        a, b = x1 / ls, x2 / ls
        d2 = (a.square().sum(-1)[:, None] + b.square().sum(-1)[None, :]
              - 2.0 * a @ b.T).clamp_min(0.0)
        return outputscale * torch.exp(-0.5 * d2)

    k_xz = ard(x, z) @ ard(z, z).T / m
    k_diag = ard(x, z).square().sum(-1) / m
    chol = tensor(params["chol_kzz"])
    a = torch.linalg.solve_triangular(chol, k_xz.T, upper=False).T
    v_mean = tensor(params["v_mean"])
    c = tensor(params["v_chol"])
    mean = params["mean_constant"] + a @ v_mean
    var = (k_diag - a.square().sum(-1) + (a @ c).square().sum(-1)).clamp_min(0.0)
    total_var = var + params["noise"]
    nll = float((0.5 * math.log(2 * math.pi) + 0.5 * total_var.log()
                 + 0.5 * (y - mean).square() / total_var).mean())
    mse = float((y - mean).square().mean())
    return nll, mse


# ---------------------------------------------------------------------------
def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rebuild_svgp(experiment_data, inducing_points, pls_kernel, noise0: float, mean0: float,
                 svgp_cfg: dict, device=None):
    """The rebuild over the learning-rate grid, best by final loss; returns
    ``(best params, test NLL, test MSE)`` (None and NaNs when every rate
    diverged)."""
    base = pls_kernel.base_kernel
    lengthscales, outputscale = _host(base.lengthscales), float(base.outputscale)
    lr_grid = np.logspace(math.log10(svgp_cfg["learning_rate_lower"]),
                          math.log10(svgp_cfg["learning_rate_upper"]),
                          svgp_cfg["number_of_learning_rate_searches"])
    best_loss, best_params = float("inf"), None
    for lr in lr_grid:
        params, losses = train_torch_svgp(
            x_train=_host(experiment_data.train.x),
            y_train=_host(experiment_data.train.y),
            x_induce=_host(inducing_points.x),
            lengthscales=lengthscales,
            outputscale=outputscale,
            noise_init=noise0,
            mean_init=mean0,
            number_of_epochs=svgp_cfg["number_of_epochs"],
            batch_size=svgp_cfg["batch_size"],
            learning_rate=float(lr),
            early_stopper_patience=svgp_cfg["early_stopper_patience"],
            seed=svgp_cfg["seed"],
            device=device,
        )
        if params is None or not losses:
            continue
        if losses[-1] < best_loss:
            best_loss, best_params = losses[-1], params
    if best_params is None:
        return None, math.nan, math.nan
    nll, mse = torch_svgp_metrics(best_params, _host(experiment_data.test.x),
                                  _host(experiment_data.test.y), _host(inducing_points.x),
                                  lengthscales, outputscale, device=device)
    return best_params, nll, mse


def harness_svgp(experiment_data, inducing_points, pls_kernel, noise0: float, mean0: float,
                 svgp_cfg: dict, models_path: str, checkpoint: str | None = None):
    """The sweep's SVGP: ``checkpoint`` loaded where it exists, else trained
    through ``train_svgp_runner`` as the UCI regression main trains it;
    returns ``(svgp, test NLL, test MSE)``."""
    device = experiment_data.train.x.device
    likelihood = GaussianLikelihood(noise=torch.tensor(noise0, dtype=experiment_data.train.x.dtype,
                                                       device=device))
    if checkpoint is not None and os.path.exists(checkpoint):
        svgp, _, _ = load_svgp(checkpoint, likelihood=likelihood, device=device)
    else:
        svgp, _, _ = train_svgp_runner(
            model_name="svgp",
            experiment_data=experiment_data,
            inducing_points=inducing_points,
            kernel=pls_kernel,
            likelihood=likelihood,
            seed=svgp_cfg["seed"],
            number_of_epochs=svgp_cfg["number_of_epochs"],
            batch_size=svgp_cfg["batch_size"],
            learning_rate_upper=svgp_cfg["learning_rate_upper"],
            learning_rate_lower=svgp_cfg["learning_rate_lower"],
            number_of_learning_rate_searches=svgp_cfg["number_of_learning_rate_searches"],
            is_fixed=True,
            observation_noise=noise0,
            mean_constant=mean0,
            early_stopper_patience=svgp_cfg["early_stopper_patience"],
            models_path=models_path,
        )
    prediction = svgp.predict_y(experiment_data.test.x)
    return (svgp, calculate_nll(prediction, experiment_data.test.y),
            calculate_mse(prediction, experiment_data.test.y))


def run_audit(dataset_names: list[str], seeds: list[int], cfg: dict, outputs_path: str,
              datasets_dir: str = DATASETS_DIR, device="cuda",
              dtype: torch.dtype = torch.float64) -> list[dict]:
    """One row a (dataset, seed): the harness's and the rebuild's test NLL,
    MSE and learned noise."""
    svgp_cfg = cfg["svgp"]
    rows = []
    for dataset_name in dataset_names:
        for seed in seeds:
            experiment_data, inducing_points, pls_kernel, noise0, mean0 = setup(
                dataset_name, seed, cfg, outputs_path, datasets_dir, device, dtype)
            models_path = os.path.join(outputs_path, str(seed), "models", dataset_name)
            svgp, harness_nll, harness_mse = harness_svgp(
                experiment_data, inducing_points, pls_kernel, noise0, mean0, svgp_cfg,
                os.path.join(models_path, "svgp-audit"), os.path.join(models_path, "svgp.pkl"))
            params, rebuild_nll, rebuild_mse = rebuild_svgp(
                experiment_data, inducing_points, pls_kernel, noise0, mean0, svgp_cfg, device)
            rows.append(dict(
                dataset=dataset_name, seed=seed, noise_init=noise0,
                harness_nll=harness_nll, rebuild_nll=rebuild_nll,
                harness_mse=harness_mse, rebuild_mse=rebuild_mse,
                harness_noise=float(svgp.likelihood.noise),
                rebuild_noise=math.nan if params is None else params["noise"],
            ))
            r = rows[-1]
            print(f"[audit] {dataset_name} seed={seed}: harness nll={r['harness_nll']:.4f} "
                  f"rebuild nll={r['rebuild_nll']:.4f} | harness mse={r['harness_mse']:.4f} "
                  f"rebuild mse={r['rebuild_mse']:.4f} | noise init={noise0:.4f} "
                  f"harness={r['harness_noise']:.4f} rebuild={r['rebuild_noise']:.4f}",
                  flush=True)
    return rows


def render(rows: list[dict]) -> str:
    lines = [
        "# SVGP regression-baseline audit (PyTorch port)",
        "",
        "The port's SVGP trainer (`experiments_torch/runners.train_svgp_runner`, the",
        "likelihood noise learned) against the plain fp64 torch rebuild of the",
        "gpytorch SVGP protocol, on identical inputs (split, averaged ARD kernel,",
        "inducing points, noise and mean initialisation). Test split. Generated by",
        "`experiments_torch/audit_svgp.py`.",
        "",
        "| dataset | seed | noise init | harness NLL | rebuild NLL | harness MSE | rebuild MSE "
        "| harness noise | rebuild noise |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['dataset']} | {r['seed']} | {r['noise_init']:.4f} "
            f"| {r['harness_nll']:.4f} | {r['rebuild_nll']:.4f} "
            f"| {r['harness_mse']:.4f} | {r['rebuild_mse']:.4f} "
            f"| {r['harness_noise']:.4f} | {r['rebuild_noise']:.4f} |"
        )
    deltas = np.array([r["harness_nll"] - r["rebuild_nll"] for r in rows])
    lines += [
        "",
        f"Mean NLL delta (harness - rebuild): {np.mean(deltas):+.4f} "
        f"(max |delta| {np.max(np.abs(deltas)):.4f} over {len(rows)} runs).",
        "",
    ]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--datasets", default="boston,energy_cooling,wine_quality")
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--config_path",
                        default=os.path.join("experiments", "uci", "regression",
                                             "config_precond_map.yaml"))
    parser.add_argument("--out", required=True, help="path of the markdown report")
    parser.add_argument("--outputs_dirname", default="outputs_audit_svgp",
                        help="outputs tree under experiments_torch/uci/regression (or an "
                        "absolute path); the sweep's own tree reuses its cached data, GPs, "
                        "inducing points and svgp.pkl")
    parser.add_argument("--datasets_dir", default=DATASETS_DIR)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    args = parser.parse_args(argv)
    outputs_path = os.path.join(os.path.dirname(os.path.realpath(__file__)), "uci", "regression",
                                args.outputs_dirname)
    rows = run_audit(args.datasets.split(","), [int(s) for s in args.seeds.split(",")],
                     load_config(args.config_path), outputs_path, args.datasets_dir,
                     args.device, getattr(torch, args.dtype))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(render(rows))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
