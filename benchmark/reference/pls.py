"""Plain reference of one PLS training run on the orthonormal (KKL) basis, as
the UCI mains run it with ``onb_scaling: nystrom``, ``mean_constant: map``
and ``discretisation: preconditioned``:

* the basis: eigh of k(Z, Z) / M in fp64, eigenpairs at or below
  ``threshold`` lambda_max dropped, Vt = V / (sqrt(M) lambda), the train
  projection P = k(X, Z) Vt (``docs/DESIGN.md`` "ONB prior scaling");
* the cost on F = m0 + P U: Gaussian, or the Bernoulli-sigmoid cost under
  residual smoothing, E_z[softplus(F + s z)] - y F with s^2 = k_ii - Q_ii and
  Q_ii = sum_k P_ik^2 lambda_k, by 16-node Gauss-Hermite quadrature;
* the prior mean constant m0: the MAP of cost + 0.5 U^T Lambda^-1 U jointly
  over [m0; U], by Newton's method to a tight tolerance;
* the preconditioned step U' = e^-eta (U - eta Lambda P^T dc(F)) +
  sqrt(Lambda (1 - e^-2eta)) eps, eps ~ N(0, I) drawn from ``generator`` as
  one (M_k, J) ``torch.randn`` a step; the energy of a step is the mean over
  particles of cost_j + 0.5 U_j^T Lambda^-1 U_j at the updated particles.

``dtype`` is the working precision; the basis is built in fp64 whatever it
is, and the noise is drawn in fp64 and rounded to it."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.common import ard


class Model(NamedTuple):
    lam: torch.Tensor  # (M_k,)
    projection: torch.Tensor  # P, (N, M_k)
    y: torch.Tensor
    cost: str  # "gaussian" or "smoothed_bernoulli"
    noise: float  # the Gaussian cost's variance
    smoothing: torch.Tensor | None  # s, (N,)
    nodes: torch.Tensor | None
    weights: torch.Tensor | None
    m0: float


def basis(x, z, lengthscales, outputscale, threshold: float):
    """``(lam, P)`` in fp64."""
    m = z.shape[0]
    kzz = ard(z, None, lengthscales, outputscale).double().cpu().numpy() / m
    lam, v = np.linalg.eigh(kzz)
    keep = lam > threshold * lam[-1]
    lam, v = lam[keep], v[:, keep]
    vt = v / (math.sqrt(m) * lam)[None, :]
    kxz = ard(x, z, lengthscales, outputscale).double().cpu().numpy()
    back = lambda a: torch.as_tensor(a, dtype=torch.float64, device=x.device)  # noqa: E731
    return back(lam), back(kxz @ vt)


def _softplus(f):
    return torch.clamp_min(f, 0.0) + torch.log1p(torch.exp(-torch.abs(f)))


def _expect(model: Model, f, fn):
    scale = math.sqrt(2.0) * model.smoothing[:, None]
    acc = torch.zeros_like(f)
    for q in range(model.nodes.shape[0]):
        acc = acc + model.weights[q] * fn(f + scale * model.nodes[q])
    return acc / math.sqrt(math.pi)


def cost(model: Model, f):
    """(J,) cost of each column of F."""
    y = model.y[:, None]
    if model.cost == "gaussian":
        return torch.sum(0.5 * (f - y) ** 2 / model.noise, dim=0)
    return torch.sum(_expect(model, f, _softplus) - y * f, dim=0)


def cost_derivative(model: Model, f):
    y = model.y[:, None]
    if model.cost == "gaussian":
        return (f - y) / model.noise
    return _expect(model, f, torch.sigmoid) - y


def _cost_curvature(model: Model, f):
    if model.cost == "gaussian":
        return torch.full_like(f, 1.0 / model.noise)
    return _expect(model, f, lambda g: torch.sigmoid(g) * (1.0 - torch.sigmoid(g)))


def make_model(x, y, z, kernel: dict, config_pls: dict, dtype) -> Model:
    """The basis, the cost and the MAP mean constant from the raw inputs."""
    ls, os_ = kernel["lengthscales"].double(), kernel["outputscale"].double()
    lam, p = basis(x.double(), z.double(), ls, os_, config_pls["onb_relative_eigenvalue_threshold"])
    y64 = y.double()
    if config_pls["cost"] == "gaussian":
        model = Model(lam, p, y64, "gaussian", float(kernel["noise"]), None, None, None, 0.0)
    else:
        q_diag = torch.sum(p * p * lam[None, :], dim=1)
        s = torch.sqrt(torch.clamp_min(float(os_) - q_diag, 0.0))
        nodes, weights = np.polynomial.hermite.hermgauss(int(config_pls["quadrature_nodes"]))
        back = lambda a: torch.as_tensor(a, dtype=torch.float64, device=x.device)  # noqa: E731
        model = Model(lam, p, y64, "smoothed_bernoulli", 0.0, s, back(nodes), back(weights), 0.0)
    model = cast(model, dtype)
    return model._replace(m0=map_mean_constant(model))


def cast(model: Model, dtype) -> Model:
    to = lambda t: None if t is None else t.to(dtype)  # noqa: E731
    return model._replace(lam=to(model.lam), projection=to(model.projection), y=to(model.y),
                          smoothing=to(model.smoothing), nodes=to(model.nodes),
                          weights=to(model.weights))


def map_mean_constant(model: Model, iterations: int = 100) -> float:
    """argmin over [m0; u] of sum cost(m0 + P u) + 0.5 u^T Lambda^-1 u, by
    damped Newton steps with a halving line search."""
    p, lam = model.projection, model.lam
    b = torch.cat([torch.ones_like(p[:, :1]), p], dim=1)
    prior = torch.cat([torch.zeros_like(lam[:1]), 1.0 / lam])

    def value(w):
        return float(cost(model, (b @ w)[:, None])[0] + 0.5 * torch.sum(prior * w * w))

    w = torch.zeros(b.shape[1], dtype=p.dtype, device=p.device)
    for _ in range(iterations):
        f = (b @ w)[:, None]
        grad = b.T @ cost_derivative(model, f)[:, 0] + prior * w
        if float(torch.max(torch.abs(grad))) < 1e-11:
            break
        hess = b.T @ (_cost_curvature(model, f)[:, 0, None] * b) + torch.diag(prior)
        step = torch.linalg.solve(hess, grad)
        t, v0 = 1.0, value(w)
        while t > 1e-9 and not value(w - t * step) <= v0:
            t *= 0.5
        w = w - t * step
    return float(w[0])


def train(model: Model, u0, eta: float, steps: int, generator: torch.Generator):
    """``(U, energies)`` after ``steps`` preconditioned steps from ``u0``."""
    dtype = model.projection.dtype
    p, lam = model.projection, model.lam[:, None]
    dec = math.exp(-eta)
    nscale = torch.sqrt(lam * -math.expm1(-2.0 * eta))
    u = u0.to(dtype)
    f = p @ u + model.m0
    energies = []
    for _ in range(steps):
        eps = torch.randn(u.shape, generator=generator, dtype=torch.float64, device=u.device).to(dtype)
        u = dec * (u - eta * (lam * (p.T @ cost_derivative(model, f)))) + nscale * eps
        f = p @ u + model.m0
        energies.append(float(torch.mean(cost(model, f) + 0.5 * torch.sum(u * u / lam, dim=0))))
    return u, energies
