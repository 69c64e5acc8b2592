from projected_langevin_sampling_torch.models.gaussian_process.exact_gp import ExactGP
from projected_langevin_sampling_torch.models.gaussian_process.likelihoods import (
    BernoulliLikelihood,
    GaussianLikelihood,
    StudentTLikelihood,
)
from projected_langevin_sampling_torch.models.gaussian_process.svgp import (
    SVGP,
    init_svgp,
    titsias_optimal_svgp,
)

__all__ = [
    "ExactGP",
    "SVGP",
    "init_svgp",
    "titsias_optimal_svgp",
    "GaussianLikelihood",
    "BernoulliLikelihood",
    "StudentTLikelihood",
]
