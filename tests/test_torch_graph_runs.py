"""The chunked runner of training runs (``utils/early_stopper.run_training``)
against per-step loops that decide the stop on the host after every step.

On the card a chunk is the replays of one captured CUDA graph; here, on the
CPU, the same step runs eagerly, which is the graph's plain version. Its
results must not depend on the chunk length: with chunks of 1, 3 and 7 steps
(the host reads the stop flag once a chunk) each run gives, bit for bit, the
per-step loop's state, recorded losses and stop, for a stop inside a chunk,
on a chunk's last step, a length that is no multiple of the chunk, a
non-finite loss, the exact GP's discarded update (with the factorisation's
deferred rescue), the SVGP's adopted update and its non-finite abort, and
the ``off`` and ``quadratic`` tiers' stop.
"""

import functools
import math

import numpy as np
import pytest
import torch

import projected_langevin_sampling_torch as pt
from projected_langevin_sampling_torch.models.gaussian_process import training as gp_training
from projected_langevin_sampling_torch.training import _train_pls_loop
from projected_langevin_sampling_torch.utils import early_stopper
from projected_langevin_sampling_torch.utils.early_stopper import run_training, take

CPU = torch.device("cpu")
CHUNKS = [1, 3, 7]


@pytest.fixture(params=CHUNKS, ids=lambda c: f"chunk{c}")
def chunk(request, monkeypatch):
    monkeypatch.setattr(early_stopper, "CHECK_EVERY", request.param)
    return request.param


def _bits(a):
    a = torch.as_tensor(a).detach().contiguous()
    return a.view(torch.int64) if a.dtype == torch.float64 else a


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _per_step(step, state, num_steps, step_size, patience, discard=False, abort=None):
    """The reference loop: one step, then the stop decided on the host."""
    min_loss, sim_time, losses = math.inf, 0.0, []
    for t in range(num_steps):
        new_state, loss = step(t, state)[:2]
        loss = float(loss)
        improved = loss < min_loss
        sim_new = 0.0 if improved else sim_time + step_size
        stop = not math.isfinite(loss) or (not improved and sim_new >= patience)
        bad = abort is not None and bool(abort(new_state))
        if not (discard and stop):
            state = new_state
        if bad:
            return state, losses, t + 1, True
        if stop:
            return state, losses, t + 1, False
        losses.append(loss)
        if improved:
            min_loss = loss
        sim_time = sim_new
    return state, losses, num_steps, False


def _recorded(run):
    return [float(e) for e, r in zip(run.energies.tolist(), run.recorded.tolist()) if r]


# --------------------------------------------------------------------------
# the runner on a toy step
# --------------------------------------------------------------------------
STEPS, ETA, PATIENCE = 16, 0.5, 1.0  # two steps without improvement stop


def _energies(stop_at):
    """A decreasing trace whose stop falls on ``stop_at``: two steps
    without improvement, or a NaN there ("nan")."""
    e = 20.0 - np.arange(STEPS, dtype=np.float64)
    if stop_at == "nan":
        e[4] = np.nan
    elif stop_at is not None:
        e[stop_at - 1:] = e[stop_at - 2] + 0.5
    return torch.as_tensor(e)


def _toy_step(energies):
    shift = torch.linspace(-1.0, 1.0, STEPS, dtype=torch.float64)

    def step(t, state):
        (x,) = state
        return (0.5 * x + take(shift, t),), take(energies, t)

    return step


# stop at 4 (inside a chunk of 3 or 7), 5 (a chunk of 3's last step), 6
# (a chunk of 7's last step), none (16 steps: no multiple of 3 or 7), NaN
@pytest.mark.parametrize("stop_at", [4, 5, 6, None, "nan"])
@pytest.mark.parametrize("discard", [False, True], ids=["adopt", "discard"])
def test_runner_matches_the_per_step_loop(chunk, stop_at, discard):
    step = _toy_step(_energies(stop_at))
    x0 = torch.arange(3, dtype=torch.float64)
    run = run_training(step, (x0,), STEPS, ETA, PATIENCE, torch.float64, CPU, discard=discard)
    state, losses, steps_run, _ = _per_step(step, (x0,), STEPS, ETA, PATIENCE, discard)
    assert _same(run.state[0], state[0])
    assert _recorded(run) == losses
    assert int(run.steps_run) == steps_run
    assert not run.aborted
    # the trace holds the stop step's energy, NaN after it
    assert torch.isnan(run.energies[steps_run:]).all()
    assert early_stopper.last_run_stats.host_syncs == math.ceil(steps_run / chunk)


@pytest.mark.parametrize("abort_at", [0, 5, 6])
def test_runner_aborts_after_adopting(chunk, abort_at):
    step = _toy_step(_energies(None))

    def blowing_up(t, state):
        (x,), e = step(t, state)
        return (torch.where(t == abort_at, math.inf, x),), e

    abort = lambda state: ~torch.isfinite(state[0]).all()  # noqa: E731
    x0 = torch.arange(3, dtype=torch.float64)
    run = run_training(blowing_up, (x0,), STEPS, ETA, math.inf, torch.float64, CPU, abort=abort)
    state, losses, steps_run, aborted = _per_step(
        lambda t, s: blowing_up(torch.tensor(t), s), (x0,), STEPS, ETA, math.inf, abort=abort)
    assert run.aborted and aborted
    assert _same(run.state[0], state[0]) and torch.isinf(run.state[0]).all()
    assert _recorded(run) == losses and int(run.steps_run) == steps_run == abort_at + 1


@pytest.mark.parametrize("defer_from", [0, 4, 6])
def test_a_deferred_step_reruns_on_the_fallback(chunk, defer_from):
    """A step that defers hands the run to the fallback at that step; where
    the two agree on every step, the run is the fallback's alone."""
    step = _toy_step(_energies(9))

    def deferring(t, state):
        new_state, e = step(t, state)
        return new_state, e, t >= defer_from

    x0 = torch.arange(3, dtype=torch.float64)
    run = run_training(deferring, (x0,), STEPS, ETA, PATIENCE, torch.float64, CPU,
                       fallback=step)
    alone = run_training(step, (x0,), STEPS, ETA, PATIENCE, torch.float64, CPU)
    assert _same(run.state[0], alone.state[0])
    assert _same(run.energies, alone.energies) and torch.equal(run.recorded, alone.recorded)
    assert int(run.steps_run) == int(alone.steps_run) == 10


# --------------------------------------------------------------------------
# the GP fits
# --------------------------------------------------------------------------
def _gp_data(n=24, d=2, seed=0, duplicates=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    if duplicates:
        x[n // 2:] = x[: n - n // 2]
    y = np.sin(x.sum(1)) + 0.1 * rng.normal(size=n)
    return torch.as_tensor(x), torch.as_tensor(y)


def _kernel(d):
    return pt.ARDKernel(torch.full((d,), 0.8, dtype=torch.float64), torch.tensor(1.2,
                                                                               dtype=torch.float64))


def _exact_per_epoch(x, y, kernel, noise, epochs, lr, patience, fixed=None):
    """fit_exact_gp's epoch as a plain loop: the factor of
    ``nan_rescued_cholesky``, optax's Adam, the discarding stopper."""
    params = (torch.tensor(0.0, dtype=torch.float64), torch.log(kernel.lengthscales),
              torch.log(kernel.outputscale), torch.log(torch.tensor(noise, dtype=torch.float64)))
    params = tuple(p.detach().clone().requires_grad_() for p in params)
    zeros = tuple(torch.zeros_like(p) for p in params)
    state = (*params, *zeros, *zeros, torch.tensor(0.0, dtype=torch.float64))

    def step(t, state):
        p, mu, nu, count = state[:4], state[4:8], state[8:12], state[12]
        gp = gp_training._exact_gp_from_params(dict(zip(gp_training._EXACT_PARAMS, p)), x, y,
                                               fixed)
        loss = -gp.log_marginal_likelihood() / y.shape[0]
        grads = torch.autograd.grad(loss, p)
        new_p, mu, nu, count = gp_training._adam(p, grads, mu, nu, count, lr)
        new_p = tuple(v.detach().requires_grad_() for v in new_p)
        return (*new_p, *mu, *nu, count), loss.detach()

    state, losses, _, _ = _per_step(step, state, epochs, lr, patience, discard=True)
    return state[:4], losses


@pytest.mark.parametrize("case", ["run", "stop", "rescued"])
def test_fit_exact_gp_matches_the_per_epoch_loop(chunk, case):
    duplicates = case == "rescued"
    x, y = _gp_data(duplicates=duplicates)
    kw = dict(noise=0.1, learning_rate=0.05, number_of_epochs=11)
    fixed = None
    if case == "stop":
        kw.update(learning_rate=0.8, early_stopper_patience=0.0)
    if case == "rescued":
        # duplicate rows make K singular; a tiny negative fixed noise makes
        # K + noise indefinite, so every plain factor fails and the run
        # takes the jitter ladder from its first epoch
        kw.update(noise=1e-12)
        fixed = torch.full((y.shape[0],), -1e-9, dtype=torch.float64)
        plain = torch.linalg.cholesky_ex(_kernel(2)(x) + (1e-12 - 1e-9) * torch.eye(y.shape[0]))
        assert int(plain[1]) != 0
    gp, losses = pt.fit_exact_gp(x, y, _kernel(2), fixed_noise_variances=fixed, **kw)
    params, ref_losses = _exact_per_epoch(x, y, _kernel(2), kw["noise"], kw["number_of_epochs"],
                                          kw["learning_rate"],
                                          kw.get("early_stopper_patience", math.inf), fixed)
    assert losses == ref_losses
    assert (0 < len(losses) < 11) if case == "stop" else len(losses) == 11
    assert _same(gp.mean_constant, params[0])
    assert _same(gp.kernel.lengthscales, torch.exp(params[1]))
    assert _same(gp.kernel.outputscale, torch.exp(params[2]))
    assert _same(gp.noise, torch.exp(params[3]))


def _svgp(d=2, m=6, seed=1):
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.uniform(-2.0, 2.0, (m, d)))
    return pt.init_svgp(0.1, _kernel(d), pt.GaussianLikelihood(noise=torch.tensor(
        0.2, dtype=torch.float64)), z)


def _svgp_per_epoch(svgp, x, y, epochs, batch, lr, patience, orders):
    names = ("mean_constant", "log_lengthscales", "log_outputscale", "variational_mean",
             "variational_chol", "log_noise")
    params = gp_training._svgp_params(svgp, False)
    n = y.shape[0]

    def sgd(p, index):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = -gp_training._svgp_from_params(p, svgp).elbo(x[index], y[index], n) / n
        grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
        return {k: p[k].detach() - lr * g for k, g in zip(names, grads)}

    def step(t, state):
        p = dict(zip(names, state))
        order = torch.as_tensor(orders[t])
        for b in range(n // batch):
            p = sgd(p, order[b * batch:(b + 1) * batch])
        if n % batch:
            p = sgd(p, order[n // batch * batch:])
        with torch.no_grad():
            loss = -gp_training._svgp_from_params(p, svgp).elbo(x, y, n) / n
        return tuple(p[k] for k in names), loss

    abort = lambda s: ~torch.stack([torch.isfinite(v).all() for v in s]).all()  # noqa: E731
    state, losses, _, aborted = _per_step(step, tuple(params[k] for k in names), epochs, lr,
                                          patience, abort=abort)
    return (None, None) if aborted else (dict(zip(names, state)), losses)


@pytest.mark.parametrize("case", ["run", "stop", "abort"])
def test_fit_svgp_matches_the_per_epoch_loop(chunk, case):
    x, y = _gp_data(n=30)
    lr, patience, epochs = {"run": (0.1, math.inf, 11), "stop": (2.0, 0.0, 11),
                            "abort": (1e6, math.inf, 5)}[case]
    orders = np.stack([np.random.default_rng(e).permutation(30) for e in range(epochs)])
    svgp = _svgp()
    fit, losses = pt.fit_svgp(svgp, x, y, epochs, 8, lr, early_stopper_patience=patience,
                              orders=orders)
    ref, ref_losses = _svgp_per_epoch(svgp, x, y, epochs, 8, lr, patience, orders)
    if case == "abort":
        assert fit is None and losses is None and ref is None
        return
    assert losses == ref_losses
    assert (0 < len(losses) < epochs) if case == "stop" else len(losses) == epochs
    assert _same(fit.variational_mean, ref["variational_mean"])
    assert _same(fit.variational_chol, ref["variational_chol"])
    assert _same(fit.kernel.lengthscales, torch.exp(ref["log_lengthscales"]))


def test_fit_svgp_permutations_do_not_depend_on_the_chunk(monkeypatch):
    """Drawn from the generator, one a step: the chunk changes no draw."""
    x, y = _gp_data(n=30)
    fits = []
    for c in CHUNKS:
        monkeypatch.setattr(early_stopper, "CHECK_EVERY", c)
        fits.append(pt.fit_svgp(_svgp(), x, y, 8, 8, 0.1, generator=5))
    for fit, losses in fits[1:]:
        assert losses == fits[0][1]
        assert _same(fit.variational_chol, fits[0][0].variational_chol)


# --------------------------------------------------------------------------
# the off and quadratic tiers
# --------------------------------------------------------------------------
def _onb_model(cost_name, n=40, m=8, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(np.sort(rng.uniform(-2.0, 2.0, (n, 1)), 0))
    y = torch.sin(2.0 * x[:, 0]) + 0.1 * torch.as_tensor(rng.normal(size=n))
    z = x[:: n // m][:m]
    kernel = pt.PLSKernel(base_kernel=pt.ARDKernel(torch.tensor([0.6], dtype=torch.float64),
                                                   torch.tensor(1.0, dtype=torch.float64)),
                          approximation_samples=z)
    basis = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    if cost_name == "student_t":
        cost = pt.StudentTCost(y_train=y, degrees_of_freedom=4.0, scale=0.3)
    else:
        cost = pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, dtype=torch.float64))
    return basis, cost


def _tier_per_step(basis, cost, u0, eta, patience, steps, tier, noise):
    """The tiers' step as a plain loop (the Euler update of ``off``; the
    quadratic tier's normal equations)."""
    def off(t, state):
        u, pred = state
        u_new = u + basis._calculate_particle_update(u, cost.calculate_cost_derivative(pred), eta,
                                                     noise[t])
        pred_new = basis.calculate_untransformed_train_prediction_samples(u_new)
        return (u_new, pred_new), torch.mean(
            basis.calculate_particle_energies(u_new, cost.calculate_cost(pred_new)))

    if tier == "off":
        state0 = (u0, basis.calculate_untransformed_train_prediction_samples(u0))
        state, losses, steps_run, _ = _per_step(off, state0, steps, eta, patience)
        return state[0], losses, steps_run
    from projected_langevin_sampling_torch.training import _quadratic_system

    a_mat, b_vec, e_mat, e_bias, e_const, shared = _quadratic_system(basis, cost)

    def quadratic(t, state):
        u, v = state
        u_new = u - eta * ((v if shared else a_mat @ u) - b_vec[:, None]) + math.sqrt(
            2.0 * eta) * noise[t]
        v_new = (a_mat if shared else e_mat) @ u_new
        return (u_new, v_new), torch.mean(
            0.5 * torch.sum(u_new * v_new, dim=0) - e_bias @ u_new + e_const)

    state0 = (u0, a_mat @ u0 if shared else torch.zeros_like(u0))
    state, losses, steps_run, _ = _per_step(quadratic, state0, steps, eta, patience)
    return state[0], losses, steps_run


@functools.lru_cache(maxsize=None)
def _near_stationary(tier, cost_name):
    """Particles after 3000 steps: their energy now wanders, so a patience
    of three steps stops a run early (at its ninth step here)."""
    basis, cost = _onb_model(cost_name)
    u0 = torch.randn(basis.approximation_dimension, 5, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    return _train_pls_loop(basis, cost, u0, 1e-3, math.inf, 3000, tier, generator=1).particles


@pytest.mark.parametrize("tier,cost_name", [("off", "student_t"), ("quadratic", "gaussian")])
@pytest.mark.parametrize("patience", [math.inf, 3e-3], ids=["run", "stop"])
def test_tiers_match_the_per_step_loop(chunk, tier, cost_name, patience):
    basis, cost = _onb_model(cost_name)
    steps, eta = 23, 1e-3
    u0 = _near_stationary(tier, cost_name)
    noise = torch.randn(steps, *u0.shape, generator=torch.Generator().manual_seed(2),
                        dtype=torch.float64)
    result = _train_pls_loop(basis, cost, u0, eta, patience, steps, tier, noise=noise)
    u, losses, steps_run = _tier_per_step(basis, cost, u0, eta, patience, steps, tier, noise)
    assert _same(result.particles, u)
    recorded = [float(e) for e, r in zip(result.energies.tolist(), result.recorded.tolist()) if r]
    assert recorded == losses and int(result.steps_run) == steps_run
    assert (steps_run < steps) == (patience != math.inf)


def test_off_tier_draws_do_not_depend_on_the_chunk(monkeypatch):
    basis, cost = _onb_model("student_t")
    u0 = torch.zeros(basis.approximation_dimension, 5, dtype=torch.float64)
    runs = []
    for c in CHUNKS:
        monkeypatch.setattr(early_stopper, "CHECK_EVERY", c)
        runs.append(_train_pls_loop(basis, cost, u0, 1e-3, math.inf, 10, "off", generator=7))
    for r in runs[1:]:
        assert _same(r.particles, runs[0].particles) and _same(r.energies, runs[0].energies)


def test_a_graph_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        run_training(_toy_step(_energies(None)), (torch.zeros(3, dtype=torch.float64),), 4,
                     ETA, PATIENCE, torch.float64, CPU, graph=True)
