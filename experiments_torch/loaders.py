"""Checkpoint save and load (counterpart of ``experiments/loaders.py``).

Every checkpoint is a pickle of a dict of numpy arrays and Python scalars,
written atomically. The exact-GP checkpoint has the JAX harness's layout, so
either harness reads the other's. The PLS basis and the SVGP likelihood,
which the JAX harness pickles as JAX pytrees, are written here as dicts of
their fields (with a ``"kind"``), the layout ``projected_langevin_sampling_torch.convert``
reads; the JAX harness's PLS and SVGP checkpoints need JAX to unpickle and
are not read here.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from experiments_torch.data import Data
from projected_langevin_sampling_torch import convert
from projected_langevin_sampling_torch.models.basis.inducing_point import InducingPointBasis
from projected_langevin_sampling_torch.models.basis.orthonormal import OrthonormalBasis
from projected_langevin_sampling_torch.models.gaussian_process import (
    SVGP,
    BernoulliLikelihood,
    ExactGP,
    GaussianLikelihood,
    StudentTLikelihood,
)
from projected_langevin_sampling_torch.ops.kernels import ARDKernel
from projected_langevin_sampling_torch.utils.device import as_tensor

_BASES = {OrthonormalBasis: ("orthonormal", convert.orthonormal_basis_from_numpy),
          InducingPointBasis: ("inducing_point", convert.inducing_point_basis_from_numpy)}
_LIKELIHOOD_KINDS = {GaussianLikelihood: "gaussian", BernoulliLikelihood: "bernoulli",
                     StudentTLikelihood: "student_t"}


def _numpy_tree(obj):
    """A dataclass as the dict of its fields, recursively; tensors as numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: _numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def _pickle_dump(path: str, obj) -> None:
    """Atomic checkpoint write: serialise fully in memory first (a conversion
    error raises before the target is touched), then write a sibling
    temporary file and rename it, so that a crashed save never leaves a
    truncated pickle for the train-or-load existence check to find."""
    payload = pickle.dumps(obj)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def _float_or_none(value) -> float | None:
    if value is None:
        return None
    return float(value.detach().cpu()) if isinstance(value, torch.Tensor) else float(value)


def save_pls(
    path: str,
    particles: torch.Tensor,
    observation_noise,
    best_lr: float | None,
    number_of_epochs: int,
    mean_constant: float | None = None,
    basis=None,
) -> None:
    """PLS checkpoint: {particles, observation_noise, best_lr,
    number_of_epochs, mean_constant, basis}. ``mean_constant`` records the
    prior mean the particles were trained under. ``basis`` makes the
    checkpoint self-contained: particles are coordinates in the basis, whose
    eigenvector signs and order an eigh does not reproduce across backends
    and dtypes. The extra predictive-noise distribution is not saved (the
    caller owns it and it is grafted back on load)."""
    basis_payload = None
    if basis is not None:
        kind, _ = _BASES[type(basis)]
        basis_payload = {
            "kind": kind,
            **_numpy_tree(basis.replace(additional_predictive_noise_distribution=None)),
        }
    _pickle_dump(
        path,
        {
            "particles": particles.detach().cpu().numpy(),
            "observation_noise": _float_or_none(observation_noise),
            "best_lr": best_lr,
            "number_of_epochs": number_of_epochs,
            "mean_constant": mean_constant,
            "basis": basis_payload,
        },
    )


def load_pls(path: str, pls=None, device=None):
    """Returns (particles, observation_noise, best_lr, number_of_epochs), the
    particles on the model's device (else ``device``, the card unless the
    caller asks for the CPU). With a model, sets its observation noise and,
    when the checkpoint carries its basis, replaces the model's basis with
    it (keeping the model's extra predictive noise), so the particles
    reproduce their train-time predictions; without one, restores the
    trained-under mean constant on the caller's basis."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    print(f"Loaded PLS particles from {path=}")
    if pls is not None:
        device = pls.basis.device
        if payload["observation_noise"] is not None:
            pls.observation_noise = payload["observation_noise"]
        saved = payload.get("basis")
        if saved is not None:
            if not isinstance(saved, dict) or "kind" not in saved:
                raise TypeError(f"{path}: the basis is not a dict of numpy arrays")
            builder = {kind: build for kind, build in _BASES.values()}[saved["kind"]]
            pls.basis = builder(saved, device=device).replace(
                additional_predictive_noise_distribution=(
                    pls.basis.additional_predictive_noise_distribution
                )
            )
        elif payload.get("mean_constant") is not None:
            print(f"  [load_pls] WARNING: {path} carries no basis; the particles are only "
                  "valid in the basis they were trained in")
            pls.basis = pls.basis.replace(mean_constant=payload["mean_constant"])
    return (
        as_tensor(payload["particles"], device=device),
        payload["observation_noise"],
        payload["best_lr"],
        payload["number_of_epochs"],
    )


def save_svgp(path: str, model: SVGP, losses: list[float] | None, best_learning_rate) -> None:
    _pickle_dump(
        path,
        {
            "mean_constant": _numpy_tree(model.mean_constant),
            "kernel": _numpy_tree(model.kernel),
            "likelihood": {"kind": _LIKELIHOOD_KINDS[type(model.likelihood)],
                           **_numpy_tree(model.likelihood)},
            "x_induce": _numpy_tree(model.x_induce),
            "variational_mean": _numpy_tree(model.variational_mean),
            "variational_chol": _numpy_tree(model.variational_chol),
            "jitter": model.jitter,
            "losses": losses,
            "best_learning_rate": best_learning_rate,
        },
    )


def load_svgp(path: str, likelihood, device=None) -> tuple[SVGP, list[float] | None, float | None]:
    """The SVGP, its losses and learning rate. The checkpoint's likelihood
    must be of the requested kind; its parameters are the checkpoint's.
    Tensors go to ``device`` (the card unless the caller asks for the CPU)."""
    with open(path, "rb") as f:
        p = pickle.load(f)
    print(f"Loaded SVGP from {path=}")
    kind = _LIKELIHOOD_KINDS[type(likelihood)]
    if not isinstance(p["likelihood"], dict) or p["likelihood"].get("kind") != kind:
        raise TypeError(f"Checkpoint likelihood at {path} is not the requested {kind!r}")
    return convert.svgp_from_numpy(p, device=device), p["losses"], p["best_learning_rate"]


def save_ard_exact_gp_model(path: str, model: ExactGP, losses: list[float] | None) -> None:
    _pickle_dump(
        path,
        {
            "mean_constant": _numpy_tree(model.mean_constant),
            "lengthscales": _numpy_tree(model.kernel.lengthscales),
            "outputscale": _numpy_tree(model.kernel.outputscale),
            "noise": _numpy_tree(model.noise),
            "x_train": _numpy_tree(model.x_train),
            "y_train": _numpy_tree(model.y_train),
            "losses": losses,
        },
    )


def load_ard_exact_gp_model(path: str, device=None) -> tuple[ExactGP, list[float] | None]:
    """The exact GP (on ``device``, the card unless the caller asks for the
    CPU) and its losses."""
    with open(path, "rb") as f:
        p = pickle.load(f)
    print(f"Loaded ExactGP from {path=}")
    tensor = lambda name: as_tensor(np.asarray(p[name]), device=device)  # noqa: E731
    model = ExactGP(
        mean_constant=tensor("mean_constant"),
        kernel=ARDKernel(lengthscales=tensor("lengthscales"), outputscale=tensor("outputscale")),
        noise=tensor("noise"),
        x_train=tensor("x_train"),
        y_train=tensor("y_train"),
    )
    return model, p["losses"]


def save_inducing_points(path: str, data: Data) -> None:
    """The inducing points as a dict of numpy arrays (the JAX main pickles
    its ``Data`` of JAX arrays under the same name)."""
    host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
    with open(path, "wb") as f:
        pickle.dump({"x": host(data.x), "y": host(data.y),
                     "y_untransformed": host(data.y_untransformed), "name": data.name}, f)


def load_inducing_points(path: str, device=None) -> Data:
    with open(path, "rb") as f:
        p = pickle.load(f)
    tensor = lambda a: None if a is None else torch.as_tensor(a, device=device)  # noqa: E731
    return Data(x=tensor(p["x"]), y=tensor(p["y"]), y_untransformed=tensor(p["y_untransformed"]),
                name=p["name"])
