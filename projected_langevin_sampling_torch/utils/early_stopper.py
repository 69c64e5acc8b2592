"""Early stopping in simulation time.

:class:`EarlyStopper` is the host-side stopper for eager loops, with the
semantics of reference ``experiments/early_stopper.py:4-24``: patience is
measured in accumulated simulation time (step sizes) while the loss does not
improve, and a non-finite loss stops at once.

:func:`replay_early_stopper` re-derives the same decisions from a whole
energy trace at once; the fused spectral kernel's wrapper uses it to find the
stop step after the run.
"""

from __future__ import annotations

import math

import torch


class EarlyStopper:
    def __init__(self, patience: float = 1e-4):
        self.patience = patience
        self.simulation_time = 0.0
        self.min_loss = float("inf")

    def should_stop(self, loss: float, step_size: float) -> bool:
        if not math.isfinite(loss):
            return True
        if loss >= self.min_loss:
            self.simulation_time += step_size
            return self.simulation_time >= self.patience
        self.min_loss = loss
        self.simulation_time = 0.0
        return False


def run_with_stopper(step, state, num_steps: int, step_size: float, patience: float,
                     dtype: torch.dtype, device, check_every: int = 256):
    """Run ``new_state, energy = step(t, state)`` for up to ``num_steps`` steps
    with the early-stopper carry of the JAX scan (``training.py:969-1015``).

    ``state`` is a tuple of tensors. Once the stopper fires the state is
    frozen and later energies are NaN; the stop step's own update is applied
    and its energy written but not recorded. The flags stay on the device;
    the loop looks at them on the host every ``check_every`` steps and ends
    early once stopped. Returns ``(state, energies, recorded, steps_run)``."""
    step_size = torch.tensor(step_size, dtype=dtype, device=device)
    patience = torch.tensor(patience, dtype=dtype, device=device)
    nan = torch.tensor(math.nan, dtype=dtype, device=device)
    min_loss = torch.tensor(math.inf, dtype=dtype, device=device)
    sim_time = torch.tensor(0.0, dtype=dtype, device=device)
    stopped = torch.tensor(False, device=device)
    steps = torch.tensor(0, dtype=torch.int32, device=device)
    energies = torch.full((num_steps,), math.nan, dtype=dtype, device=device)
    recorded = torch.zeros(num_steps, dtype=torch.bool, device=device)
    for t in range(num_steps):
        if t % check_every == 0 and t and bool(stopped):
            break
        new_state, energy = step(t, state)
        energy = torch.where(stopped, nan, energy)
        state = tuple(torch.where(stopped, old, new) for old, new in zip(state, new_state))
        finite = torch.isfinite(energy)
        improved = energy < min_loss
        sim_time_new = torch.where(improved, torch.zeros_like(sim_time), sim_time + step_size)
        should_stop = (~finite) | ((~improved) & (sim_time_new >= patience))
        min_loss = torch.where(stopped, min_loss, torch.where(improved, energy, min_loss))
        sim_time = torch.where(stopped, sim_time, sim_time_new)
        energies[t] = energy
        recorded[t] = (~stopped) & (~should_stop)
        steps = steps + (~stopped).to(torch.int32)
        stopped = stopped | should_stop
    return state, energies, recorded, steps


def replay_early_stopper(
    energies: torch.Tensor, step_size: float, patience: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(recorded, steps_run) of the stopper replayed over an energy trace.

    A step improves iff its energy beats the running minimum before it; the
    simulation time at step t is ``step_size * (t - last improvement)``; the
    stop is the first step that is non-finite or whose time reaches the
    patience. ``recorded`` is True before the stop (the stop step's energy is
    written but not recorded) and ``steps_run = min(stop + 1, T)``. Entries
    after the stop are NaN in a fused run and cannot create an earlier stop.
    """
    dtype, device = energies.dtype, energies.device
    t = energies.shape[0]
    if t == 0:
        return torch.zeros(0, dtype=torch.bool, device=device), torch.tensor(0, dtype=torch.int32)
    # scalars made on the device (torch.full), not copied from the host: a
    # copy from pageable host memory waits for the stream, and a kernel's
    # wrapper calls this right after queueing its run
    step_size = torch.full((), step_size, dtype=dtype, device=device)
    patience = torch.full((), patience, dtype=dtype, device=device)
    inf = torch.full((1,), math.inf, dtype=dtype, device=device)

    finite = torch.isfinite(energies)
    safe = torch.where(finite, energies, inf)
    cummin_excl = torch.cat([inf, torch.cummin(safe, dim=0).values[:-1]])
    improved = energies < cummin_excl
    idx = torch.arange(t, device=device)
    last_improved = torch.cummax(
        torch.where(improved, idx, torch.full_like(idx, -1)), dim=0
    ).values
    sim_time = step_size * (idx - last_improved).to(dtype)
    stop_here = (~finite) | ((~improved) & (sim_time >= patience))
    stop_idx = torch.where(
        stop_here.any(), torch.argmax(stop_here.to(torch.int32)),
        torch.full((), t, dtype=torch.int64, device=device),
    )
    recorded = idx < stop_idx
    steps_run = torch.clamp(stop_idx + 1, max=t).to(torch.int32)
    return recorded, steps_run
