"""Plain reference of one exact-GP kernel fit as the mains run it: Adam
(optax's defaults: b1 0.9, b2 0.999, eps 1e-8) on the negative exact
marginal log-likelihood per data point (gpytorch's ExactMarginalLogLikelihood
over N), constant mean, ARD kernel, Gaussian noise, the positive parameters
in log space. K + noise I is factored as it stands; once a factor fails, the
rest of the fit takes the first of the jitters 1e-6 .. 1e-2 (x10) that
factors, as gpytorch's retries."""

from __future__ import annotations

import math

import torch

from benchmark.reference.common import ard

LEAVES = ("mean_constant", "log_lengthscales", "log_outputscale", "log_noise")
B1, B2, EPS = 0.9, 0.999, 1e-8


def _factor(matrix: torch.Tensor, ladder: bool):
    eye = torch.eye(matrix.shape[0], dtype=matrix.dtype, device=matrix.device)
    for jitter in ([0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2] if ladder else [0.0]):
        chol, info = torch.linalg.cholesky_ex(matrix + jitter * eye)
        if int(info) == 0 and bool(torch.isfinite(chol).all()):
            return chol
    return None


def neg_mll(p: dict, x, y, ladder: bool):
    """-MLL / n, or None where K + noise I does not factor."""
    n = y.shape[0]
    k = ard(x, None, torch.exp(p["log_lengthscales"]), torch.exp(p["log_outputscale"]))
    chol = _factor(k + torch.exp(p["log_noise"]) * torch.eye(n, dtype=x.dtype, device=x.device), ladder)
    if chol is None:
        return None
    r = (y - p["mean_constant"])[:, None]
    alpha = torch.cholesky_solve(r, chol)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return 0.5 * (torch.sum(r * alpha) + logdet + n * math.log(2.0 * math.pi)) / n


def fit(x, y, init: dict, epochs: int, learning_rate: float):
    """``(params, losses)`` after ``epochs`` Adam steps from ``init``."""
    p = {k: init[k].detach().clone() for k in LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, ladder = [], False
    for t in range(1, epochs + 1):
        q = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = neg_mll(q, x, y, ladder)
        if loss is None:
            ladder = True
            loss = neg_mll(q, x, y, ladder)
        grads = torch.autograd.grad(loss, [q[k] for k in LEAVES])
        c1, c2 = 1.0 - B1**t, 1.0 - B2**t
        for k, g in zip(LEAVES, grads):
            mu[k] = (1.0 - B1) * g + B1 * mu[k]
            nu[k] = (1.0 - B2) * g * g + B2 * nu[k]
            p[k] = p[k] - learning_rate * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS))
        losses.append(float(loss.detach()))
    return p, losses
