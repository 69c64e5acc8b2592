"""The MAP fit of the prior mean constant against the JAX package (CPU,
fp64), on a basis and costs carried across with ``convert``.

Both run the same damped Newton iteration with the same line search, so the
iterates agree up to the fp64 reassociation of the gradients and the linear
solves: rtol 1e-8 on m0."""

import numpy as np
import pytest

from projected_langevin_sampling_torch.models.mean_constant import fit_mean_constant_map
from projected_langevin_sampling_tpu.models.mean_constant import (
    fit_mean_constant_map as j_fit_mean_constant_map,
)
from tests.torch_parity import carried, jax_cost, jax_onb

RTOL = 1e-8


@pytest.mark.parametrize("name, initial_constant", [
    ("gaussian", 0.0), ("bernoulli", 0.0), ("smoothed", 0.0), ("poisson", 1.5),
])
def test_fit_mean_constant_matches_jax(name, initial_constant):
    jbasis, _, x, _ = jax_onb()
    jcost = jax_cost(name, x)
    if name == "gaussian":
        jcost = jcost.replace(y_train=jcost.y_train + 0.7)  # a constant the basis must fit
    tbasis, tcost = carried(jbasis, jcost)
    expected = j_fit_mean_constant_map(jbasis, jcost, initial_constant=initial_constant)
    got = fit_mean_constant_map(tbasis, tcost, initial_constant=initial_constant)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, expected, rtol=RTOL)
    assert abs(got) > 1e-3  # a nonzero constant was fitted


def test_fit_mean_constant_starts_from_a_nonzero_basis_constant():
    jbasis, _, x, _ = jax_onb()
    jcost = jax_cost("bernoulli", x)
    tbasis, tcost = carried(jbasis, jcost)
    expected = fit_mean_constant_map(tbasis, tcost)
    assert fit_mean_constant_map(tbasis.replace(mean_constant=5.0), tcost) == expected


def test_fit_mean_constant_refuses_a_non_finite_start():
    jbasis, _, x, _ = jax_onb()
    tbasis, tcost = carried(jbasis, jax_cost("poisson", x))
    with pytest.raises(ValueError, match="non-finite"):
        fit_mean_constant_map(tbasis, tcost)  # -2 y log|0| at m0 = 0
    with pytest.raises(ValueError, match="non-finite"):
        j_fit_mean_constant_map(jbasis, jax_cost("poisson", x))
    assert np.isfinite(fit_mean_constant_map(tbasis, tcost, initial_constant=2.0))
