"""Early stopping in simulation time, and the runner of whole training runs.

:class:`EarlyStopper` is the host-side stopper for eager loops, with the
semantics of reference ``experiments/early_stopper.py:4-24``: patience is
measured in accumulated simulation time (step sizes) while the loss does not
improve, and a non-finite loss stops at once.

:func:`run_training` is the counterpart of the JAX package's jitted scans
with the stopper carried as scan state (``training.py:687`` and
``models/gaussian_process/training.py:82-140, 302-400`` there): the stopper
lives on the device as 0-d tensors updated with ``torch.where``, and the host
looks at its flag once a chunk of steps, as the JAX ``_drain_chunks`` does.
On CUDA tensors one step is captured into a ``torch.cuda.CUDAGraph`` after a
warm-up step on a side stream and replayed; elsewhere the same step runs
eagerly, which is the plain version of the graphed run. Chunking changes no
number: once stopped the state freezes. A capture that fails raises; nothing
falls back to eager steps on the card.

:func:`replay_early_stopper` re-derives the same decisions from a whole
energy trace at once; the fused spectral kernel's wrapper uses it to find the
stop step after the run.
"""

from __future__ import annotations

import contextlib
import math
import os
import traceback
from typing import NamedTuple

import torch

from projected_langevin_sampling_torch.utils.tracing import span


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


# (object, attribute) of every launch counter a kernel wrapper keeps: a graph
# replays the launches its capture counted, so each replay adds them again
REPLAYED_COUNTERS: list[tuple[object, str]] = []


def count_replays(owner, attribute: str) -> None:
    """Register a wrapper's launch counter with the graphed runs."""
    REPLAYED_COUNTERS.append((owner, attribute))


# steps a chunk: the host reads the stop flag once a chunk
CHECK_EVERY = 256

_EAGER_ON_CARD = False


@contextlib.contextmanager
def _eager_on_card():
    """Run :func:`run_training` eagerly on CUDA tensors too: the plain
    version of the graphed run, which ``chip_smoke.py`` holds the graphs to."""
    global _EAGER_ON_CARD
    before, _EAGER_ON_CARD = _EAGER_ON_CARD, True
    try:
        yield
    finally:
        _EAGER_ON_CARD = before


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER for the run's factorisations on the card, the graph's and
    the eager runner's alike (MAGMA's may synchronise with the host)."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


class NoiseChunks:
    """Injected standard normals of a run too long to hold at once, the
    chunked form of a tier's (T, M, J) ``noise``: ``draw(start, n)`` returns
    those of steps start .. start + n - 1 as an (n, M, J) CPU tensor, asked
    for ``chunk_steps`` steps at a time. CPU runs only: reading a step's
    index on the host would break a CUDA graph."""

    def __init__(self, draw, num_steps: int, chunk_steps: int = 4096):
        self.draw, self.num_steps, self.chunk_steps = draw, int(num_steps), int(chunk_steps)
        self._start, self._chunk = 0, None

    def map(self, fn) -> NoiseChunks:
        """The same normals with ``fn`` applied to each chunk (a rotation
        into a tier's eigenbasis)."""
        return NoiseChunks(lambda start, n: fn(self.draw(start, n)), self.num_steps,
                           self.chunk_steps)

    def step(self, t) -> torch.Tensor:
        t = int(t)
        if not 0 <= t < self.num_steps:
            raise IndexError(f"step {t} of a {self.num_steps}-step run")
        if self._chunk is None or not self._start <= t < self._start + self._chunk.shape[0]:
            self._start, self._chunk = t, self.draw(t, min(self.chunk_steps, self.num_steps - t))
        return self._chunk[t - self._start]


def take(values, t) -> torch.Tensor:
    """``values[t]`` for an int or a 0-d index tensor; a tensor is not read
    on the host (``values[t]`` would read it). ``values`` may be a
    :class:`NoiseChunks`."""
    if isinstance(values, NoiseChunks):
        return values.step(t)
    if isinstance(t, int):
        return values[t]
    return values.index_select(0, t.reshape(1))[0]


class TrainingRun(NamedTuple):
    state: tuple  # the final state
    energies: torch.Tensor  # (T,) energy or loss per step, NaN once stopped
    recorded: torch.Tensor  # (T,) bool, True where the reference would append
    steps_run: torch.Tensor  # scalar int, steps executed before stopping
    aborted: bool  # the abort check fired on an adopted step


class RunStats(NamedTuple):
    mode: str  # "graph" or "eager"
    steps: int  # steps launched (the step of each chunk after the stop included)
    host_syncs: int  # reads of the device flags, one a chunk
    captures: int  # graphs captured


last_run_stats: RunStats | None = None


def _where_failed(exc: BaseException) -> str:
    """The innermost frame of this package in ``exc``'s traceback."""
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename).startswith(package)
              and not f.filename.endswith("early_stopper.py")]
    if not frames:
        return ""
    f = frames[-1]
    return f" at {os.path.relpath(f.filename, os.path.dirname(package))}:{f.lineno} ({f.line})"


class _Program:
    """One step captured into a CUDA graph, with the launch counts of its
    capture replayed onto the counters."""

    def __init__(self, body, device, generators, what: str):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with span("pls.run_training.warmup"), torch.cuda.stream(side):
            body()  # the warm-up is a step of the run
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        before = [getattr(o, a) for o, a in REPLAYED_COUNTERS]
        try:
            with span("pls.run_training.capture"), torch.cuda.graph(self.graph, stream=side):
                body()
        except Exception as exc:
            raise RuntimeError(
                f"CUDA-graph capture of {what} failed{_where_failed(exc)}: {exc}"
            ) from exc
        self.deltas = []
        for (owner, attribute), b in zip(REPLAYED_COUNTERS, before):
            self.deltas.append(getattr(owner, attribute) - b)
            setattr(owner, attribute, b)  # a capture launches nothing
        torch.cuda.current_stream(device).wait_stream(side)

    def replay(self) -> None:
        self.graph.replay()
        for (owner, attribute), d in zip(REPLAYED_COUNTERS, self.deltas):
            if d:
                setattr(owner, attribute, getattr(owner, attribute) + d)

    def close(self) -> None:
        self.graph.reset()


def run_training(step, state, num_steps: int, step_size: float, patience: float, dtype,
                 device, *, discard: bool = False, abort=None, fallback=None, generators=(),
                 graph: bool | None = None, what: str = "a training run") -> TrainingRun:
    """Run ``step(t, state)`` for up to ``num_steps`` steps with the stopper
    carried on the device.

    ``step`` returns ``(new_state, energy)`` or ``(new_state, energy,
    defer)``; ``t`` is a 0-d int64 tensor on the device (read it with
    :func:`take`). ``state`` is a tuple of tensors, copied once; each step
    adopts its update with ``torch.where``, so the state keeps its storage
    (a graph's inputs). The stopper follows the three JAX scan bodies: a
    non-finite energy stops at once, else the stop comes once the energy has
    not improved for ``patience`` of simulation time (``step_size`` a step);
    the stop step's energy is written but not recorded, and its update is
    adopted (``training.py:969-1015`` of the JAX package, and its SVGP) or,
    with ``discard``, dropped (its exact GP). ``abort(new_state)`` (a 0-d
    bool) stops after adopting the step and marks the run aborted (the
    SVGP's non-finite parameters). A step whose ``defer`` is True is not
    taken: the state freezes, the host sees the flag at the chunk's end and
    runs the rest of the run on ``fallback`` (the same signature, without
    ``defer``) from that step, as the exact GP's rescued factorisation does.

    ``graph`` (default: CUDA tensors, unless :func:`_eager_on_card`): each
    chunk's steps are replays of one captured step, after a warm-up step on
    a side stream; ``generators`` are the CUDA generators the step draws
    from, registered with the graph so its draws are the eager loop's. The
    host reads the flags once every :data:`CHECK_EVERY` steps.

    Under the profiler the run is the span ``pls.run_training``, holding one
    ``.warmup`` and one ``.capture`` a graph captured, one ``.chunk`` (the
    chunk's replays or eager steps) and one ``.sync`` (its flag read) a
    chunk, and one ``.close`` a graph closed (``utils/tracing.span``)."""
    global last_run_stats
    device = torch.device(device)
    if graph is None:
        graph = device.type == "cuda" and not _EAGER_ON_CARD
    if graph and device.type != "cuda":
        raise ValueError("a graphed run needs CUDA tensors")
    with span("pls.run_training"):
        state = tuple(s.detach().clone().requires_grad_(s.requires_grad) for s in state)
        full = lambda v, dt=dtype: torch.full((), v, dtype=dt, device=device)  # noqa: E731
        min_loss, sim_time, nan = full(math.inf), full(0.0), full(math.nan)
        stopped, bad, pending = (full(False, torch.bool) for _ in range(3))
        t, steps = full(0, torch.int64), full(0, torch.int32)
        energies = torch.full((num_steps,), math.nan, dtype=dtype, device=device)
        recorded = torch.zeros(num_steps, dtype=torch.bool, device=device)

        def body(step_fn):
            out = step_fn(t, state)
            new_state, energy = out[0], out[1]
            with torch.no_grad():
                energy = energy.detach()
                live = ~(stopped | pending)
                if len(out) > 2:
                    defer = live & out[2]
                    live = live & ~out[2]
                    pending.logical_or_(defer)
                finite = torch.isfinite(energy)
                improved = energy < min_loss
                sim_time_new = torch.where(improved, 0.0, sim_time + step_size)
                stop_now = ~finite | (~improved & (sim_time_new >= patience))
                if abort is not None:
                    bad_now = live & abort(new_state)
                    bad.logical_or_(bad_now)
                    stop_now = stop_now | bad_now
                adopt = live & ~stop_now if discard else live
                for old, new in zip(state, new_state):
                    old.copy_(torch.where(adopt, new.detach(), old))
                min_loss.copy_(torch.where(live & improved, energy, min_loss))
                sim_time.copy_(torch.where(live, sim_time_new, sim_time))
                energies.index_copy_(0, t.reshape(1), torch.where(live, energy, nan).reshape(1))
                recorded.index_copy_(0, t.reshape(1), (live & ~stop_now).reshape(1))
                steps.add_(live.to(torch.int32))
                stopped.logical_or_(live & stop_now)
                t.add_((~pending).to(torch.int64))

        step_fn, program = step, None
        launched = syncs = captures = 0
        done = 0  # steps taken, as the device counts them
        with _cusolver(device):
            try:
                while done < num_steps:
                    n = min(CHECK_EVERY, num_steps - done)
                    k = 0
                    if graph and program is None:
                        program = _Program(lambda: body(step_fn), device, generators, what)
                        captures += 1
                        k = 1  # the warm-up step
                    with span("pls.run_training.chunk"):
                        for _ in range(k, n):
                            if program is None:
                                body(step_fn)
                            else:
                                program.replay()
                    launched += n
                    with span("pls.run_training.sync"):
                        flags = torch.stack([stopped.to(torch.int64), pending.to(torch.int64), t])
                        is_stopped, is_pending, done = flags.tolist()
                    syncs += 1
                    if is_stopped:
                        break
                    if is_pending:
                        if fallback is None:
                            raise RuntimeError(f"{what}: a step deferred with no fallback")
                        step_fn, fallback = fallback, None
                        pending.fill_(False)
                        if program is not None:
                            with span("pls.run_training.close"):
                                program.close()
                            program = None
            finally:
                if program is not None:
                    with span("pls.run_training.close"):
                        torch.cuda.synchronize(device)
                        program.close()
        last_run_stats = RunStats("graph" if graph else "eager", launched, syncs, captures)
        return TrainingRun(state, energies, recorded, steps, bool(bad))


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
