"""Empirical-Bayes fit of the PLS prior-mean constant (counterpart of
``projected_langevin_sampling_tpu/models/mean_constant.py``).

The reference PLS prior is zero-mean, while its SVGP baseline trains a
``ConstantMean``. The PLS analogue: point-estimate the prior mean constant
``m0`` at the MAP of the penalised posterior jointly over ``[m0; u]``,

    (m0*, u*) = argmin  cost(link(m0 + B u)) + 0.5 u^T Lambda^{-1} u,

with ``m0`` unpenalised, then run Langevin with the basis mean shifted by
``m0*``. The optimiser is a damped Newton method with a backtracking line
search over M_k + 1 variables, run once per model build.
"""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.models.basis.base import PLSBasisMixin
from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin


def fit_mean_constant_map(
    basis: PLSBasisMixin,
    cost: PLSCostMixin,
    *,
    newton_iterations: int = 60,
    damping: float = 1e-8,
    gradient_tolerance: float = 1e-6,
    initial_constant: float = 0.0,
) -> float:
    """MAP-optimal prior mean constant for ``basis`` and ``cost``, as a
    Python float; the caller replaces the basis's ``mean_constant`` with it.

    Works for any cost that is a sum of per-point terms (every cost of the
    package), since the analytic Hessian relies on a diagonal f-Hessian.
    Convex costs converge globally; for non-convex ones the result is a local
    optimum, and a Newton direction that is not a descent direction falls
    back to the scaled gradient. ``initial_constant`` is the start of m0;
    links singular at f = 0 (the Poisson square link) need a nonzero one.

    Raises ``ValueError`` if the objective is non-finite at the start."""
    if basis.mean_constant != 0.0:
        basis = basis.replace(mean_constant=0.0)
    m_k = basis.approximation_dimension
    dtype, device = basis.dtype, basis.device

    def predict(u):  # linear in u (mean_constant forced to 0 above)
        return basis.calculate_untransformed_train_prediction_samples(u[:, None])[:, 0]

    def data_sum(f):
        return torch.sum(cost.calculate_cost(f[:, None]))

    def prior_only(u):
        # the basis energy with zero cost isolates the (quadratic) prior term
        return basis.calculate_energy_potential(
            particles=u[:, None], cost=torch.zeros(1, dtype=u.dtype, device=u.device)
        )

    def objective(w):
        return data_sum(predict(w[1:]) + w[0]) + prior_only(w[1:])

    grad_and_value = torch.func.grad_and_value(objective)

    # Analytic Hessian: f(w) = b_aug @ w exactly, the f-Hessian of a
    # per-point cost is diagonal and the prior quadratic, so
    #   H(w) = b_aug^T diag(c''(f)) b_aug + blockdiag(0, prior).
    # One gradient-of-gradient pass and one (N, M_k + 1) product per Newton
    # iteration, instead of M_k + 1 tangents through the whole cost.
    zeros_u = torch.zeros(m_k, dtype=dtype, device=device)
    j_u = torch.func.jacfwd(predict)(zeros_u)  # (N, M_k), built once
    b_aug = torch.cat([torch.ones((j_u.shape[0], 1), dtype=dtype, device=device), j_u], dim=1)
    prior_block = torch.zeros((m_k + 1, m_k + 1), dtype=dtype, device=device)
    prior_block[1:, 1:] = torch.func.hessian(prior_only)(zeros_u)
    grad_f = torch.func.grad(data_sum)
    # row sums of the f-Hessian == its diagonal for per-point costs
    hess_diag_f = torch.func.grad(lambda f: torch.sum(grad_f(f)))

    def hessian(w):
        h = hess_diag_f(b_aug @ w)
        return b_aug.T @ (h[:, None] * b_aug) + prior_block

    w = torch.zeros(m_k + 1, dtype=dtype, device=device)
    w[0] = initial_constant
    grad, value = grad_and_value(w)
    if not bool(torch.isfinite(value)):
        raise ValueError(
            "fit_mean_constant_map: objective is non-finite at the "
            f"m0={initial_constant} start — the cost/label configuration is "
            "invalid (links singular at f=0 need a nonzero initial_constant)"
        )
    eye = torch.eye(m_k + 1, dtype=dtype, device=device)
    for _ in range(newton_iterations):
        if float(torch.max(torch.abs(grad))) < gradient_tolerance:
            break
        hess = hessian(w)
        scale = torch.clamp_min(torch.max(torch.abs(torch.diagonal(hess))), 1.0)
        step = torch.linalg.solve(hess + damping * scale * eye, grad)
        if not bool(torch.all(torch.isfinite(step))) or float(torch.dot(grad, step)) <= 0.0:
            # a failed solve, or an indefinite Hessian gave an ascent
            # direction: the scaled gradient keeps the line search descending
            step = grad / scale
        # backtracking line search: halve until the objective decreases
        t = 1.0
        for _ in range(30):
            w_new = w - t * step
            grad_new, value_new = grad_and_value(w_new)
            if bool(torch.isfinite(value_new)) and float(value_new) <= float(value):
                break
            t *= 0.5
        else:
            break  # no decrease in 30 halvings: converged or stuck
        converged = float(value) - float(value_new) < 1e-12 * max(1.0, abs(float(value)))
        w, value, grad = w_new, value_new, grad_new
        if converged:
            break
    return float(w[0])
