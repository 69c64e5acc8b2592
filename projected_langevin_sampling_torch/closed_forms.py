"""The one rule from a cost and its link to the card's closed form of it
(``ops/cuda/cost_forms.py``), and which kernels take that form.

:data:`RULES` maps (cost class, link class) to a kind and its parameters
(p0, p1, p2) as ``cost_forms.cost_and_dc`` and both kernels read them; every
other cost and link has no closed form (a rule on types, never a failed
launch). B3 (``general_train``, the ``general_fused`` tier) takes every kind
on the orthonormal basis, the Bernoulli kinds at its one jitter
``general_train.JITTER`` and the smoothed cost with the hermgauss(16) rule
alone, else the two tiers would train different costs
(:func:`general_fused_form`). B5 (``fused_update``) takes the kinds of
``fused_update.KINDS`` at any jitter (:func:`dc_kind_for_cost`).
:func:`general_fused_cost_spec` and :func:`dc_kind_for_cost` give the rule in
the shapes of the JAX package's two rules.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.costs import (
    BernoulliCost,
    GaussianCost,
    MultiModalCost,
    PoissonCost,
    SmoothedBernoulliCost,
    StudentTCost,
)
from projected_langevin_sampling_torch.models.link_functions import (
    IdentityLinkFunction,
    ProbitLinkFunction,
    SigmoidLinkFunction,
    SquareLinkFunction,
)
from projected_langevin_sampling_torch.ops.cuda import cost_forms, fused_update, general_train


class ClosedForm(NamedTuple):
    kind: str  # one of cost_forms.COST_KINDS
    params: tuple[float, float, float]  # (p0, p1, p2)
    aux: torch.Tensor | None  # the smoothed kind's per-row stds


def _jitter(cost):
    return float(cost.link_function.jitter), 0.0, 0.0


def _none(cost):
    return 0.0, 0.0, 0.0


RULES = {
    (GaussianCost, IdentityLinkFunction):
        ("gaussian", lambda c: (float(c.observation_noise), 0.0, 0.0)),
    (BernoulliCost, SigmoidLinkFunction): ("bernoulli_sigmoid", _jitter),
    (SmoothedBernoulliCost, SigmoidLinkFunction): ("bernoulli_sigmoid_smoothed", _none),
    (BernoulliCost, ProbitLinkFunction): ("bernoulli_probit", _jitter),
    (PoissonCost, SquareLinkFunction): ("poisson_square", _none),
    (StudentTCost, IdentityLinkFunction):
        ("student_t", lambda c: (float(c.degrees_of_freedom), float(c.scale), 0.0)),
    # the closed-form responsibility-weighted gradient (the cost itself trains
    # by autograd, as in the reference)
    (MultiModalCost, IdentityLinkFunction): ("multimodal_identity", lambda c: (
        float(c.observation_noise), float(c.shift), float(c.bernoulli_noise))),
}


def closed_form(cost) -> ClosedForm | None:
    """The cost's closed form by :data:`RULES`, or None."""
    for (cost_type, link_type), (kind, params) in RULES.items():
        if isinstance(cost, cost_type) and isinstance(cost.link_function, link_type):
            aux = cost.smoothing_std if kind == "bernoulli_sigmoid_smoothed" else None
            return ClosedForm(kind, params(cost), aux)
    return None


def _is_gh16_rule(cost) -> bool:
    """True when the cost's (gh_nodes, gh_weights) is numerically the
    physicists' hermgauss(16) rule that the general kernel applies (rtol
    covers an fp32 cast; atol 0 so the 2.6e-10 weights compare relatively).
    Always a numeric check: a torch tensor is never abstract."""
    nodes = cost.gh_nodes.detach().cpu().numpy()
    weights = cost.gh_weights.detach().cpu().numpy()
    return bool(
        nodes.shape == cost_forms.GH16_NODES.shape
        and np.allclose(nodes, cost_forms.GH16_NODES, rtol=1e-5, atol=0)
        and np.allclose(weights, cost_forms.GH16_WEIGHTS, rtol=1e-5, atol=0)
    )


def general_fused_form(basis, cost) -> ClosedForm | None:
    """The closed form B3 trains this basis and cost with, or None."""
    form = closed_form(cost)
    if form is None or not isinstance(basis, OrthonormalBasis):
        return None
    if cost_forms.KINDS[form.kind].jitter and form.params[0] != general_train.JITTER:
        return None
    if form.kind == "bernoulli_sigmoid_smoothed" and not _is_gh16_rule(cost):
        return None
    return form


def general_fused_cost_spec(basis, cost):
    """``(cost_kind, p0, p1, p2, aux)`` of :func:`general_fused_form`, or
    None, as the JAX package gives it: no jitter for the Bernoulli kinds."""
    form = general_fused_form(basis, cost)
    if form is None:
        return None
    jax_params = (0.0, 0.0, 0.0) if cost_forms.KINDS[form.kind].jitter else form.params
    return (form.kind, *jax_params, form.aux)


def dc_kind_for_cost(cost):
    """``(kind, (p0, p1))`` of the closed form B5 updates this cost with, or
    None."""
    form = closed_form(cost)
    return None if form is None or form.kind not in fused_update.KINDS else (
        form.kind, form.params[:2])
