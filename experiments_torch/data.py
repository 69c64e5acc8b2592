"""Experiment data containers (counterpart of ``experiments/data.py``).

``Data`` and ``ExperimentData`` hold tensors on one device. ``save`` writes
the JAX harness's payload, a pickle of a dict of numpy arrays, and ``load``
reads it, so either harness reads the other's ``experiment_data.pkl``.
``read_csv_columns`` reads a dataset CSV without pandas.
"""

from __future__ import annotations

import csv
import enum
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from projected_langevin_sampling_torch.utils.device import as_tensor


class ProblemType(str, enum.Enum):
    POISSON_REGRESSION = "poisson_regression"
    REGRESSION = "regression"
    CLASSIFICATION = "classification"
    MULTIMODAL_REGRESSION = "multimodal_regression"


@dataclass
class Data:
    x: torch.Tensor
    y: torch.Tensor | None = None
    y_untransformed: torch.Tensor | None = None
    name: str = "data"


def _to_numpy(t: torch.Tensor | None) -> np.ndarray | None:
    return None if t is None else t.detach().cpu().numpy()


@dataclass
class ExperimentData:
    name: str
    problem_type: ProblemType
    full: Data
    train: Data | None = None
    test: Data | None = None
    validation: Data | None = None
    y_mean: float = 0.0
    y_std: float = 1.0

    def save(self, path: str) -> None:
        def to_np(d: Data | None):
            if d is None:
                return None
            return {"x": _to_numpy(d.x), "y": _to_numpy(d.y),
                    "y_untransformed": _to_numpy(d.y_untransformed), "name": d.name}

        payload = {
            "name": self.name,
            "problem_type": self.problem_type.value,
            "full": to_np(self.full),
            "train": to_np(self.train),
            "test": to_np(self.test),
            "validation": to_np(self.validation),
            "y_mean": float(self.y_mean),
            "y_std": float(self.y_std),
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @staticmethod
    def load(path: str, problem_type: ProblemType, device=None,
             dtype: torch.dtype | None = None) -> ExperimentData:
        """The payload at ``path`` as tensors on ``device`` (the card unless
        the caller asks for the CPU), cast to ``dtype`` where given."""
        with open(path, "rb") as f:
            payload = pickle.load(f)

        def tensor(a):
            return None if a is None else as_tensor(a, device=device, dtype=dtype)

        def from_np(d, name):
            if d is None:
                return None
            return Data(x=tensor(d["x"]), y=tensor(d["y"]),
                        y_untransformed=tensor(d["y_untransformed"]), name=name)

        return ExperimentData(
            name=payload["name"],
            problem_type=problem_type,
            full=from_np(payload["full"], "full"),
            train=from_np(payload["train"], "train"),
            test=from_np(payload["test"], "test"),
            validation=from_np(payload["validation"], "validation"),
            y_mean=float(payload["y_mean"]),
            y_std=float(payload["y_std"]),
        )


def read_csv_columns(path: str) -> dict[str, list[str]]:
    """A CSV with a header row as ``{column name: its cells as text}``, in
    the header's order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [row for row in rows[1:] if row]
    for number, row in enumerate(body, start=2):
        if len(row) != len(header):
            raise ValueError(f"{path}:{number}: {len(row)} cells, the header has {len(header)}")
    return {name: [row[i] for row in body] for i, name in enumerate(header)}


def read_dataset(path: str, schema) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) as numpy fp64 from a dataset CSV, the columns matched lower
    case with the spaces removed; y stays text for the caller to read."""
    columns = {name.lower().replace(" ", ""): cells
               for name, cells in read_csv_columns(path).items()}
    key = lambda name: name.lower().replace(" ", "")  # noqa: E731
    x = np.array([columns[key(c)] for c in schema.input_column_names], dtype=float).T
    return x, np.asarray(columns[key(schema.output_column_name)])
