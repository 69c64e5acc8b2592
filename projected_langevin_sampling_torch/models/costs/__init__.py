from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.costs.bernoulli import BernoulliCost
from projected_langevin_sampling_torch.models.costs.gaussian import GaussianCost
from projected_langevin_sampling_torch.models.costs.multimodal import MultiModalCost
from projected_langevin_sampling_torch.models.costs.poisson import PoissonCost
from projected_langevin_sampling_torch.models.costs.smoothed_bernoulli import (
    SmoothedBernoulliCost,
    make_smoothed_bernoulli_cost,
    residual_smoothing_std,
)
from projected_langevin_sampling_torch.models.costs.student_t import StudentTCost

PLSCost = PLSCostMixin  # the reference's class name

__all__ = [
    "PLSCost",
    "PLSCostMixin",
    "BernoulliCost",
    "GaussianCost",
    "MultiModalCost",
    "PoissonCost",
    "SmoothedBernoulliCost",
    "StudentTCost",
    "make_smoothed_bernoulli_cost",
    "residual_smoothing_std",
]
