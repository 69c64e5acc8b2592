"""projected_langevin_sampling_torch: the PyTorch and CUDA port of
``projected_langevin_sampling_tpu`` for NVIDIA Hopper (H100).

Ported so far: ARD and PLS grams, greedy inducing points, the orthonormal
(KKL eigen-) and inducing-point bases, every closed-form cost (Gaussian,
Bernoulli, smoothed Bernoulli, Poisson, Student-T, the bimodal mixture) with
the MAP mean constant, Langevin training on the off, quadratic,
quadratic_fused, spectral and general_fused tiers under the euler,
exponential and preconditioned discretisations, the throughput path
``langevin_steps``, Matheron prediction with optional extra (Student-T or
normal) predictive noise, the baseline GPs (exact GP, SVGP, their
likelihoods, Dirichlet targets) and their fits, and the calibration layer
(tempering of PLS and GPs, spread tempering of PLS classifiers, split
conformal prediction), and scale-out over ``torch.distributed``
(``parallel/``: a (data, particles) mesh, sharded Langevin steps, training
with the particles sharded, mesh-sharded chunked serving). Five kernels are
written by hand for ``sm_90a`` (``csrc/``): the whole-run spectral,
general-cost and quadratic trainers, the fused general update and the ARD
gram. Entry points put their tensors on ``cuda`` unless the caller passes
CPU tensors or ``device="cpu"``.

TF32 is switched off for the whole process on import: TF32 on Hopper keeps
about three decimal digits, the same fault as the TPU's bf16 operands inside
the squared-distance cancellation of the grams. The gram kernel carries a
gradient (its autograd Function), so the GP fits learn their kernels on the
card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from projected_langevin_sampling_torch.models import link_functions  # noqa: E402
from projected_langevin_sampling_torch.models.basis.inducing_point import (  # noqa: E402
    InducingPointBasis,
    build_inducing_point_basis,
)
from projected_langevin_sampling_torch.models.basis.orthonormal import (  # noqa: E402
    OrthonormalBasis,
    build_orthonormal_basis,
)
from projected_langevin_sampling_torch.models.basis.noise_distributions import (  # noqa: E402
    NormalPredictiveNoise,
    StudentTPredictiveNoise,
)
from projected_langevin_sampling_torch.models.conformalise import (  # noqa: E402
    ConformaliseGP,
    ConformalisePLS,
)
from projected_langevin_sampling_torch.models.costs import (  # noqa: E402
    BernoulliCost,
    GaussianCost,
    MultiModalCost,
    PoissonCost,
    SmoothedBernoulliCost,
    StudentTCost,
    make_smoothed_bernoulli_cost,
    residual_smoothing_std,
)
from projected_langevin_sampling_torch.models.gaussian_process import (  # noqa: E402
    SVGP,
    BernoulliLikelihood,
    ExactGP,
    GaussianLikelihood,
    StudentTLikelihood,
    init_svgp,
    titsias_optimal_svgp,
)
from projected_langevin_sampling_torch.models.gaussian_process.dirichlet import (  # noqa: E402
    dirichlet_classification_targets,
)
from projected_langevin_sampling_torch.models.gaussian_process.training import (  # noqa: E402
    fit_exact_gp,
    fit_svgp,
)
from projected_langevin_sampling_torch.models.inducing_point_selectors.conditional_variance import (  # noqa: E402,E501
    ConditionalVarianceInducingPointSelector,
)
from projected_langevin_sampling_torch.models.inducing_point_selectors.random import (  # noqa: E402
    RandomInducingPointSelector,
)
from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map  # noqa: E402
from projected_langevin_sampling_torch.models.pls import PLS  # noqa: E402
from projected_langevin_sampling_torch.models.temper.gp import TemperGP  # noqa: E402
from projected_langevin_sampling_torch.models.temper.pls import TemperPLS  # noqa: E402
from projected_langevin_sampling_torch.models.temper.pls_classification import (  # noqa: E402
    TemperPLSClassification,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel, PLSKernel  # noqa: E402
from projected_langevin_sampling_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    PARTICLE_AXIS,
    initialize_multi_host,
    make_mesh,
    parallel_langevin_steps,
    parallel_langevin_steps_with_noise,
    parallel_train_pls,
)
from projected_langevin_sampling_torch.training import langevin_steps, train_pls  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "PLS",
    "ARDKernel",
    "PLSKernel",
    "OrthonormalBasis",
    "build_orthonormal_basis",
    "InducingPointBasis",
    "build_inducing_point_basis",
    "GaussianCost",
    "BernoulliCost",
    "SmoothedBernoulliCost",
    "PoissonCost",
    "StudentTCost",
    "MultiModalCost",
    "make_smoothed_bernoulli_cost",
    "residual_smoothing_std",
    "fit_mean_constant_map",
    "link_functions",
    "train_pls",
    "langevin_steps",
    "TemperPLS",
    "TemperGP",
    "TemperPLSClassification",
    "ConformalisePLS",
    "ConformaliseGP",
    "ConditionalVarianceInducingPointSelector",
    "RandomInducingPointSelector",
    "StudentTPredictiveNoise",
    "NormalPredictiveNoise",
    "ExactGP",
    "SVGP",
    "init_svgp",
    "titsias_optimal_svgp",
    "GaussianLikelihood",
    "BernoulliLikelihood",
    "StudentTLikelihood",
    "dirichlet_classification_targets",
    "fit_exact_gp",
    "fit_svgp",
    "DATA_AXIS",
    "PARTICLE_AXIS",
    "initialize_multi_host",
    "make_mesh",
    "parallel_train_pls",
    "parallel_langevin_steps",
    "parallel_langevin_steps_with_noise",
]
