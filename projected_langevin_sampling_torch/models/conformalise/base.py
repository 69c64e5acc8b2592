"""Split conformal prediction (counterpart of
``projected_langevin_sampling_tpu/models/conformalise/base.py``; reference
``conformalise/base.py``, the method of arXiv 2107.07511).

Calibration scores are max(lower - y, y - upper) on the calibration split;
their coverage-level quantile, with the (n+1)/n finite-sample correction,
widens the raw bounds on both sides; bounds never cross the median.

Keyword arguments after ``y_calibration`` (and after ``x`` in the predict
methods) are injected noise, passed through to the subclass's draws of the
calibration and the test points: the parity hook of ``ConformalisePLS``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np
import torch


def quantile(values: torch.Tensor, q: float, dim: int = 0) -> torch.Tensor:
    """The q-quantile along ``dim`` by numpy's default 'linear' rule (which
    ``jnp.quantile`` and ``torch.quantile`` use): sort, then interpolate
    between the two order statistics around q (n - 1). Sorting directly has
    no size limit (``torch.quantile`` refuses inputs above 2^24 elements)."""
    ordered = torch.sort(values, dim=dim).values
    position = float(q) * (values.shape[dim] - 1)
    low = int(np.floor(position))
    high = min(low + 1, values.shape[dim] - 1)
    weight = position - low
    v_low = ordered.select(dim, low)
    v_high = ordered.select(dim, high)
    return v_low + weight * (v_high - v_low)


@dataclass
class ConformalPrediction:
    coverage: float
    mean: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor


class ConformaliseBase(ABC):
    def __init__(self, x_calibration: torch.Tensor, y_calibration: torch.Tensor, **noise):
        self.x_calibration = x_calibration
        self.y_calibration = y_calibration
        self.number_of_calibration_points = x_calibration.shape[0]
        self._calibration_noise = noise

    @abstractmethod
    def _predict_uncalibrated_coverage(
        self, x: torch.Tensor, coverage: float, **noise
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw (lower, upper) bounds at the given coverage level."""
        raise NotImplementedError

    @abstractmethod
    def predict_median(self, x: torch.Tensor, **noise) -> torch.Tensor:
        raise NotImplementedError

    def _calculate_calibration(self, coverage: float) -> float:
        """The conformal widening (reference ``base.py:58-90``)."""
        lower, upper = self._predict_uncalibrated_coverage(
            self.x_calibration, coverage, **self._calibration_noise
        )
        scores = torch.maximum(lower - self.y_calibration, self.y_calibration - upper)
        n = self.number_of_calibration_points
        q = float(np.clip((n + 1) * coverage / n, 0.0, 1.0))
        return float(quantile(scores, q))

    def predict_coverage(
        self, x: torch.Tensor, coverage: float, **noise
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Calibrated (lower, upper) bounds, clamped so that neither crosses
        the median (reference ``base.py:92-114``)."""
        calibration = self._calculate_calibration(coverage)
        lower, upper = self._predict_uncalibrated_coverage(x, coverage, **noise)
        lower, upper = lower - calibration, upper + calibration
        median = self.predict_median(x, **noise)
        return torch.minimum(lower, median), torch.maximum(upper, median)

    def calculate_average_interval_width(self, x: torch.Tensor, coverage: float, **noise) -> float:
        lower, upper = self.predict_coverage(x, coverage, **noise)
        return float(torch.mean(upper - lower))

    def predict_variance(self, x: torch.Tensor, **noise) -> torch.Tensor:
        """Half the interval width at 2/3 coverage (reference ``base.py:130-141``)."""
        lower, upper = self.predict_coverage(x, 2.0 / 3.0, **noise)
        return (upper - lower) / 2.0

    def predict(self, x: torch.Tensor, coverage: float, **noise) -> ConformalPrediction:
        lower, upper = self.predict_coverage(x, coverage, **noise)
        return ConformalPrediction(
            coverage=coverage, mean=self.predict_median(x, **noise), lower=lower, upper=upper
        )

    def __call__(self, x: torch.Tensor, coverage: float, **noise) -> ConformalPrediction:
        return self.predict(x, coverage, **noise)
