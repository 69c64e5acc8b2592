"""B5's plain version (``ops/cuda/fused_update.py``) against the JAX package
(CPU).

1. The four closed forms x both bases at JAX's own test size (N=70, M=16,
   J=24, fp32) against ``fused_langevin_update(interpret=True)``: rtol 2e-4
   / atol 2e-5, Poisson rtol 5e-3, the tolerances of ``tests/test_pallas.py``
   (fp32 sums in another order; the Poisson derivative's 1/f pole amplifies
   them, so its particles start at u + 2, the JAX test's shift).
2. The same in fp64 against the JAX package's unfused update: rtol 1e-10.
3. The dispatch: ``closed_forms.dc_kind_for_cost`` has a closed form exactly
   where ``dc_fn_for_cost`` has one (the mixture, the smoothed Bernoulli and
   the probit link have none), and the wrapper refuses the kinds it has no
   instance of.
4. The shared Bernoulli derivative p - y (``ops/cuda/cost_forms.py``) is bit
   for bit B5's earlier -y (1 - p) + (1 - y) p on labels in {0, 1}."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.closed_forms import dc_kind_for_cost
from projected_langevin_sampling_torch.ops.cuda import cost_forms
from projected_langevin_sampling_torch.ops.cuda import fused_update as tfused
from projected_langevin_sampling_tpu.models import costs as jcosts
from projected_langevin_sampling_tpu.models.link_functions import SigmoidLinkFunction
from projected_langevin_sampling_tpu.ops.pallas import dc_fn_for_cost
from tests.test_pallas import _costs, _fused, _reference_update, _setup
from tests.torch_parity import carried, carried_cost, carried_ipb, jax_cost, to_np

N, J = 70, 24
ETA = 1e-3  # tests/test_pallas.py's step
COSTS = ["gaussian", "bernoulli", "poisson", "student_t"]


def _port_update(which, tbasis, tcost, u, noise):
    kind, params = dc_kind_for_cost(tcost)
    if which == "onb":
        d, prior = tbasis.train_projection, 1.0 / tbasis.eigenvalues
    else:
        d = tbasis.base_gram_induce_train.T
        prior = tbasis.approximation_dimension * tbasis.inv_base_gram_induce
    return tfused.fused_update(tbasis.train_projection, d, tcost.y_train, u, prior, noise, kind,
                               eta=ETA, params=params, mean_shift=tbasis.mean_constant)


def _inputs(which, cost_name, dtype):
    rng = np.random.default_rng(1)
    jbasis, _ = _setup(which)
    jcost = _costs(rng)[cost_name]
    m = jbasis.approximation_dimension
    u = rng.normal(size=(m, J)).astype(dtype)
    if cost_name == "poisson":
        u = u + 2.0  # keep f away from the 1/f pole
    noise = rng.normal(size=(m, J)).astype(dtype)
    return jbasis, jcost, u, noise


def _carry(which, jbasis, jcost, dtype):
    tbasis, tcost = (carried if which == "onb" else carried_ipb)(jbasis, jcost)
    cast = {name: getattr(tbasis, name).to(dtype) for name in (
        ("train_projection", "eigenvalues") if which == "onb"
        else ("train_projection", "base_gram_induce_train", "inv_base_gram_induce"))}
    return tbasis.replace(**cast), tcost.replace(y_train=tcost.y_train.to(dtype))


@pytest.mark.parametrize("which", ["onb", "ipb"])
@pytest.mark.parametrize("cost_name", COSTS)
def test_plain_version_matches_jax_kernel(which, cost_name):
    jbasis, jcost, u, noise = _inputs(which, cost_name, np.float32)
    expected = _fused(jbasis, jcost, jnp.asarray(u), jnp.asarray(noise), which)
    tbasis, tcost = _carry(which, jbasis, jcost, torch.float32)
    before = tfused.fused_update.launches
    got = _port_update(which, tbasis, tcost, torch.as_tensor(u), torch.as_tensor(noise))
    assert tfused.fused_update.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32
    rtol = 5e-3 if cost_name == "poisson" else 2e-4
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=rtol, atol=2e-5)


@pytest.mark.parametrize("which", ["onb", "ipb"])
@pytest.mark.parametrize("cost_name", COSTS)
def test_plain_version_matches_jax_unfused_update_fp64(which, cost_name):
    jbasis, jcost, u, noise = _inputs(which, cost_name, np.float64)
    jcost = jcost.replace(y_train=jnp.asarray(jcost.y_train, dtype=jnp.float64))
    expected = _reference_update(jbasis, jcost, jnp.asarray(u), jnp.asarray(noise))
    tbasis, tcost = _carry(which, jbasis, jcost, torch.float64)
    got = _port_update(which, tbasis, tcost, torch.as_tensor(u), torch.as_tensor(noise))
    np.testing.assert_allclose(to_np(got), np.asarray(expected), rtol=1e-10, atol=1e-12)


def test_dc_dispatch_matches_jax():
    x = np.linspace(-2, 2, N)[:, None]
    named = {name: jax_cost(name, x) for name in (
        "gaussian", "bernoulli", "poisson", "student_t", "multimodal", "smoothed",
        "bernoulli_probit")}
    # the fused update applies any sigmoid jitter, unlike the general kernel
    named["bernoulli_jitter"] = jcosts.BernoulliCost(
        y_train=named["bernoulli"].y_train, link_function=SigmoidLinkFunction(jitter=1e-6))
    for name, jcost in named.items():
        spec = dc_kind_for_cost(carried_cost(jcost))
        assert (spec is None) == (dc_fn_for_cost(jcost) is None), name
    for name in ("multimodal", "smoothed", "bernoulli_probit"):
        assert dc_kind_for_cost(carried_cost(named[name])) is None, name
    assert dc_kind_for_cost(carried_cost(named["student_t"])) == ("student_t", (4.0, 0.3))
    assert dc_kind_for_cost(carried_cost(named["bernoulli_jitter"])) == (
        "bernoulli_sigmoid", (1e-6, 0.0))


@pytest.mark.parametrize("kind", [
    "hinge", "bernoulli_probit", "multimodal_identity", "bernoulli_sigmoid_smoothed"])
def test_wrapper_refuses_what_it_cannot_launch(kind):
    p = torch.zeros((5, 3), device="meta")
    u = torch.zeros((3, 2), device="meta")
    y = torch.zeros(5, device="meta")
    with pytest.raises(ValueError, match="particles on meta"):
        tfused.fused_update(p, p, y, u, y[:3], u, "gaussian", eta=0.1, params=(1.0, 0.0))
    with pytest.raises(ValueError, match=f"fused_update: no instance of the cost kind '{kind}'"):
        tfused.fused_update(p, p, y, u, y[:3], u, kind, eta=0.1)
    with pytest.raises(ValueError, match=f"fused_drift: no instance of the cost kind '{kind}'"):
        tfused.fused_drift(p, p, y, u, kind)
    assert tfused.step_operations("gaussian", 5000, 512, 1000, prior_is_diag=False) > 1.07e10


@pytest.mark.parametrize("dtype, bits", [(torch.float32, torch.int32), (torch.float64, torch.int64)])
@pytest.mark.parametrize("jitter", [1e-10, 1e-6])
def test_shared_bernoulli_dc_is_the_earlier_form_on_binary_labels(dtype, bits, jitter):
    f = torch.linspace(-40.0, 40.0, 8001, dtype=dtype)[:, None]
    jit = max(jitter, torch.finfo(dtype).eps)
    p = torch.clamp(torch.sigmoid(f), jit, 1.0 - jit)
    assert bool((p == jit).any() and (p == 1.0 - jit).any())  # both ends clip
    for label in (0.0, 1.0):
        y = torch.full_like(f, label)
        earlier = -y * (1.0 - p) + (1.0 - y) * p
        _, dc = cost_forms.cost_and_dc("bernoulli_sigmoid", f, y, None, (jitter, 0.0, 0.0))
        assert torch.equal(dc.view(bits), earlier.view(bits)), label
