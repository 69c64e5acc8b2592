"""The gradient of the port's gram (B2's autograd Function) against JAX's
autodiff of ``ard_gram`` and torch's autograd of the plain version (CPU,
fp64, rtol 1e-10).

On the card every non-``diag`` gram is the kernel inside ``ARDGram``, whose
backward is ``ard_gram_scaled_backward``. On the CPU the public gram is the
plain version, so these tests route ``ops/kernels.ard_gram`` through
``ARDGram`` (its forward takes the plain version for CPU tensors) to hold
the backward the card runs. Inputs have no duplicate rows across x1 and x2:
an exact tie at distance 0 off the diagonal is where JAX's ``maximum`` splits
its gradient, and is outside these tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.ops import kernels as tk
from projected_langevin_sampling_torch.ops.cuda import gram as tgram
from projected_langevin_sampling_tpu.ops import kernels as jk
from tests.torch_parity import to_np

RTOL = 1e-10


def _case(d, same, seed=0, n1=23, n2=17):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(n1, d))
    x2 = x1 if same else rng.normal(size=(n2, d))
    ls = np.linspace(0.6, 1.9, d)
    s = 1.4
    g = rng.normal(size=(n1, x2.shape[0]))  # dL/dK
    return x1, x2, ls, s, g


def _jax_grads(x1, x2, ls, s, g, same):
    def loss(x1, x2, ls, s):
        kernel = jk.ARDKernel(ls, s)
        return jnp.sum(jnp.asarray(g) * jk.ard_gram(kernel, x1, None if same else x2))

    argnums = (0, 2, 3) if same else (0, 1, 2, 3)
    grads = jax.grad(loss, argnums=argnums)(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                                            jnp.asarray(s))
    grads = [np.asarray(v) for v in grads]
    return (grads[0], None, grads[1], grads[2]) if same else tuple(grads)


def _torch_grads(x1, x2, ls, s, g, same, through_function):
    tx1 = torch.tensor(x1, requires_grad=True)
    tx2 = None if same else torch.tensor(x2, requires_grad=True)
    tls = torch.tensor(ls, requires_grad=True)
    ts = torch.tensor(s, dtype=torch.float64, requires_grad=True)
    kernel = tk.ARDKernel(tls, ts)
    gram = tk.ard_gram(kernel, tx1, tx2)
    if through_function:
        assert type(gram.grad_fn).__name__ == "ARDGramBackward"
    torch.sum(torch.as_tensor(g) * gram).backward()
    return (to_np(tx1.grad), None if same else to_np(tx2.grad), to_np(tls.grad),
            to_np(ts.grad))


@pytest.fixture
def through_function(monkeypatch):
    """ops/kernels.ard_gram routed through ARDGram, as on the card."""
    monkeypatch.setattr(tk, "ard_gram_scaled",
                        lambda a, b, s, same=False: tgram.ARDGram.apply(a, b, s, same))


def _close(got, expected):
    for g, e in zip(got, expected):
        if e is None:
            assert g is None
            continue
        np.testing.assert_allclose(g, e, rtol=RTOL, atol=1e-12 * np.abs(e).max())


@pytest.mark.parametrize("same", [False, True], ids=["cross", "same"])
@pytest.mark.parametrize("d", [1, 8])
def test_function_gradient_matches_jax_grad(d, same, through_function):
    case = _case(d, same)
    got = _torch_grads(*case, same, through_function=True)
    _close(got, _jax_grads(*case, same))


@pytest.mark.parametrize("same", [False, True], ids=["cross", "same"])
@pytest.mark.parametrize("d", [1, 8])
def test_function_gradient_matches_plain_autograd(d, same, monkeypatch):
    case = _case(d, same, seed=1)
    plain = _torch_grads(*case, same, through_function=False)
    monkeypatch.setattr(tk, "ard_gram_scaled",
                        lambda a, b, s, same=False: tgram.ARDGram.apply(a, b, s, same))
    _close(_torch_grads(*case, same, through_function=True), plain)


@pytest.mark.parametrize("same", [False, True], ids=["cross", "same"])
def test_backward_formula_on_scaled_inputs(same):
    """``ard_gram_scaled_backward`` itself against autograd of the plain
    version, on inputs already divided by the lengthscales."""
    x1, x2, _, s, g = _case(3, same, seed=2)
    a = torch.tensor(x1, requires_grad=True)
    b = a if same else torch.tensor(x2, requires_grad=True)
    ts = torch.tensor(s, dtype=torch.float64, requires_grad=True)
    gram = tgram.ard_gram_scaled_reference(a, b, ts, same)
    torch.sum(torch.as_tensor(g) * gram).backward()
    g1, g2, gs = tgram.ard_gram_scaled_backward(torch.as_tensor(g), a.detach(), b.detach(),
                                                gram.detach(), s, same)
    got_x = g1 + g2 if same else g1
    _close((to_np(got_x), to_np(gs)), (to_np(a.grad), to_np(ts.grad)))
    if not same:
        _close((to_np(g2),), (to_np(b.grad),))


def test_clamped_and_diagonal_entries_carry_no_distance_gradient():
    """An entry at the kernel's exact outputscale (the same-input diagonal,
    or a distance clamped at 0) adds nothing to the input gradients; the
    outputscale's gradient still counts it."""
    x = torch.tensor([[0.0], [1.0], [3.0]], dtype=torch.float64)
    gram = tgram.ard_gram_scaled_reference(x, x, 2.0, same=True)
    grad = torch.zeros_like(gram)
    grad[0, 0] = grad[1, 1] = 1.0  # only the diagonal
    g1, g2, gs = tgram.ard_gram_scaled_backward(grad, x, x, gram, 2.0, same=True)
    assert torch.all(g1 == 0) and torch.all(g2 == 0)
    assert float(gs) == 2.0  # (1 * 2 + 1 * 2) / 2
    # a cross gram whose rows 1 and 0 coincide: the distance clamps at 0
    x2 = torch.tensor([[1.0], [5.0]], dtype=torch.float64)
    gram = tgram.ard_gram_scaled_reference(x, x2, 2.0)
    assert float(gram[1, 0]) == 2.0
    grad = torch.zeros_like(gram)
    grad[1, 0] = 1.0
    g1, g2, _ = tgram.ard_gram_scaled_backward(grad, x, x2, gram, 2.0)
    assert torch.all(g1 == 0) and torch.all(g2 == 0)


def test_outputscale_as_float_takes_no_gradient():
    x1, x2, _, _, g = _case(2, False, seed=3)
    a = torch.tensor(x1, requires_grad=True)
    gram = tgram.ARDGram.apply(a, torch.as_tensor(x2), 1.7, False)
    torch.sum(torch.as_tensor(g) * gram).backward()
    assert a.grad is not None and torch.isfinite(a.grad).all()
    np.testing.assert_allclose(to_np(gram), to_np(tgram.ard_gram_scaled_reference(
        a.detach(), torch.as_tensor(x2), 1.7)), rtol=0, atol=0)
