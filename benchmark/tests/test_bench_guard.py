"""The check that a run loaded neither JAX nor the JAX package compares
whole top-level names."""

import sys
import types

import pytest

from benchmark.run import forbidden_modules


@pytest.fixture
def modules():
    added = []

    def add(name):
        sys.modules[name] = types.ModuleType(name)
        added.append(name)

    yield add
    for name in added:
        sys.modules.pop(name, None)


def test_nothing_forbidden_in_the_harness():
    import benchmark.harness.data  # noqa: F401
    import benchmark.harness.timing  # noqa: F401
    import benchmark.reference.pls  # noqa: F401

    before = set(forbidden_modules())
    assert not ({"projected_langevin_sampling_tpu", "flax"} & before)


@pytest.mark.parametrize("name,top", [("jaxlib.xla_client", "jaxlib"), ("flax.linen", "flax"),
                                      ("projected_langevin_sampling_tpu.ops", "projected_langevin_sampling_tpu")])
def test_forbidden_names_are_found(modules, name, top):
    modules(name)
    assert top in forbidden_modules()


@pytest.mark.parametrize("name", ["jax_like_tool", "projected_langevin_sampling_torch_extra", "jaxx"])
def test_whole_names_only(modules, name):
    before = set(forbidden_modules())
    modules(name)
    assert set(forbidden_modules()) == before


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import os

    from benchmark.run import HERE

    for root, _, files in os.walk(os.path.join(HERE, "reference")):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                             else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    for n in names:
                        assert n.split(".")[0] not in (
                            "jax", "jaxlib", "flax", "projected_langevin_sampling_tpu",
                            "projected_langevin_sampling_torch"), (f, n)
