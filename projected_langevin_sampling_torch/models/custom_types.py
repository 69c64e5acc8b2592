"""Model-type unions (counterpart of
``projected_langevin_sampling_tpu/models/custom_types.py``; reference
``src/custom_types.py:11-13``)."""

from __future__ import annotations

from typing import Union

from projected_langevin_sampling_torch.models.conformalise import (
    ConformaliseBase,
    ConformalisePLS,
)
from projected_langevin_sampling_torch.models.gaussian_process import SVGP, ExactGP
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.models.temper.base import TemperBase
from projected_langevin_sampling_torch.models.temper.pls import TemperPLS

MODEL_TYPE = Union[ExactGP, SVGP, PLS, TemperBase, ConformaliseBase]
GP_TYPE = Union[ExactGP, SVGP]
PLS_TYPE = Union[PLS, ConformalisePLS, TemperPLS]
