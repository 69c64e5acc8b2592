"""Plain reference of one SVGP fit as the regression main runs it: SGD on the
minibatched negative ELBO per data point (gpytorch's VariationalELBO and
CholeskyVariationalDistribution, whitened), on the projected r-kernel over
the inducing points, with the kernel and the inducing points frozen and the
mean constant, q(u) and the noise learned. Each epoch visits a permutation of
the rows in batches and then the remainder as one shorter batch; the loss
recorded for an epoch is the full-data loss after its updates. The
permutations come from ``generator``, one ``torch.randperm`` an epoch."""

from __future__ import annotations

import math

import torch

from benchmark.reference.common import jitter_floor, r_diag, r_gram, safe_cholesky

LEAVES = ("mean_constant", "variational_mean", "variational_chol", "log_noise")


def neg_elbo(p: dict, x, y, n: int, z, lengthscales, outputscale) -> torch.Tensor:
    """-ELBO / n on the batch (x, y) of an n-row data set."""
    kzz = r_gram(z, z, z, lengthscales, outputscale)
    chol = safe_cholesky(kzz, max(1e-8, jitter_floor(kzz.dtype)))
    kxz = r_gram(x, z, z, lengthscales, outputscale)
    a = torch.linalg.solve_triangular(chol, kxz.T, upper=False).T
    c = torch.tril(p["variational_chol"])
    v = p["variational_mean"]
    mean = p["mean_constant"] + a @ v
    var = r_diag(x, z, lengthscales, outputscale) - torch.sum(a * a, 1) + torch.sum((a @ c) ** 2, 1)
    var = torch.clamp_min(var, 0.0)
    noise = torch.exp(p["log_noise"])
    ell = -0.5 * torch.log(2.0 * math.pi * noise) - 0.5 * (y - mean) ** 2 / noise - 0.5 * var / noise
    kl = 0.5 * (torch.sum(c * c) + v @ v - v.shape[0] - 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(c)))))
    return -((n / x.shape[0]) * torch.sum(ell) - kl) / n


def fit(x, y, z, lengthscales, outputscale, init: dict, epochs: int, batch_size: int,
        learning_rate: float, generator: torch.Generator):
    """``(params, losses)`` after ``epochs`` epochs from ``init``."""
    n = x.shape[0]
    batch_size = min(batch_size, n)
    full = max(n // batch_size, 1)
    p = {k: init[k].detach().clone() for k in LEAVES}
    losses = []
    for _ in range(epochs):
        order = torch.randperm(n, generator=generator, device=x.device)
        batches = [order[b * batch_size:(b + 1) * batch_size] for b in range(full)]
        if n > full * batch_size:
            batches.append(order[full * batch_size:])
        for idx in batches:
            q = {k: v.detach().requires_grad_() for k, v in p.items()}
            loss = neg_elbo(q, x[idx], y[idx], n, z, lengthscales, outputscale)
            grads = torch.autograd.grad(loss, [q[k] for k in LEAVES])
            p = {k: q[k].detach() - learning_rate * g for k, g in zip(LEAVES, grads)}
        with torch.no_grad():
            losses.append(float(neg_elbo(p, x, y, n, z, lengthscales, outputscale)))
    return p, losses
