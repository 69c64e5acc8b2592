from projected_langevin_sampling_torch.models.conformalise.base import (
    ConformalPrediction,
    ConformaliseBase,
)
from projected_langevin_sampling_torch.models.conformalise.gp import ConformaliseGP
from projected_langevin_sampling_torch.models.conformalise.pls import ConformalisePLS

__all__ = [
    "ConformalPrediction",
    "ConformaliseBase",
    "ConformaliseGP",
    "ConformalisePLS",
]
