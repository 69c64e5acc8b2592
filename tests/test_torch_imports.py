"""The PyTorch port, its experiment harness, its chip smoke script and the
scripts that run it on the card import nothing of JAX (jax, flax, optax)
and nothing of the JAX package; the harness (every module under
``experiments_torch/``, slice 8's tools and slice 9's results pipeline
included) and the script that runs the pipeline on the card also nothing of
the JAX harness, pandas, tabulate, scikit-learn, matplotlib or yaml, which
the card's machine lacks. An AST scan of every module."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "projected_langevin_sampling_tpu"}
HARNESS_FORBIDDEN = FORBIDDEN | {"experiments", "pandas", "tabulate", "sklearn", "matplotlib",
                                 "yaml"}
HARNESS = sorted((ROOT / "experiments_torch").rglob("*.py")) + [
    ROOT / "scripts" / "results_cards.py"]
FILES = sorted((ROOT / "projected_langevin_sampling_torch").rglob("*.py")) + HARNESS + [
    ROOT / "chip_smoke.py",
    ROOT / "examples" / "readme_demo_torch.py",
    ROOT / "examples" / "classification_demo_torch.py",
    ROOT / "tests" / "torch_parallel_worker.py",
    ROOT / "scripts" / "b1_b2_breakdown.py",
    ROOT / "scripts" / "b3_b5_breakdown.py",
    ROOT / "scripts" / "mma_sync_ceiling.py",
    ROOT / "scripts" / "kernel_outputs.py",
    ROOT / "scripts" / "scale_out_cards.py",
    ROOT / "scripts" / "uci_pls_seeds.py",
    ROOT / "scripts" / "curve_mains.py",
    ROOT / "scripts" / "slice8_tools.py",
    ROOT / "scripts" / "parallel_main_cards.py",
    ROOT / "scripts" / "card_draws_replay.py",
]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    forbidden = HARNESS_FORBIDDEN if path in HARNESS else FORBIDDEN
    assert not _imported_roots(path) & forbidden


def test_port_has_the_slice_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("ops/kernels.py", "ops/linalg.py", "training.py", "convert.py",
                   "ops/cuda/gram.py", "ops/cuda/spectral_train.py",
                   "models/basis/orthonormal.py", "models/pls.py",
                   "ops/cuda/general_train.py", "ops/cuda/tc_product.py",
                   "models/mean_constant.py",
                   "models/costs/bernoulli.py", "models/costs/poisson.py",
                   "models/costs/student_t.py", "models/costs/multimodal.py",
                   "models/costs/smoothed_bernoulli.py", "models/basis/inducing_point.py",
                   "ops/cuda/quadratic_train.py", "ops/cuda/fused_update.py",
                   "models/basis/noise_distributions.py",
                   "models/inducing_point_selectors/random.py", "utils/prng.py",
                   "models/gaussian_process/likelihoods.py",
                   "models/gaussian_process/exact_gp.py", "models/gaussian_process/svgp.py",
                   "models/gaussian_process/dirichlet.py",
                   "models/gaussian_process/training.py", "models/temper/gp.py",
                   "models/temper/pls_classification.py", "models/conformalise/base.py",
                   "models/conformalise/gp.py", "models/conformalise/pls.py",
                   "models/custom_types.py", "parallel/__init__.py", "parallel/mesh.py",
                   "parallel/sharded.py", "parallel/auto.py", "utils/backend.py",
                   "utils/columns.py"):
        assert f"projected_langevin_sampling_torch/{module}" in names


def test_harness_has_the_slice_modules():
    names = {str(p.relative_to(ROOT)) for p in HARNESS}
    for module in ("utils.py", "config.py", "data.py", "uci/constants.py",
                   "uci/make_synthetic_datasets.py", "preprocess.py", "constructors.py",
                   "loaders.py", "metrics.py", "trainers.py", "runners.py",
                   "uci/regression/main.py", "uci/classification/main.py",
                   "curves/curves.py", "curves/common.py", "curves/regression/main.py",
                   "curves/classification/main.py", "curves/poisson_regression/main.py",
                   "curves/poisson_regression/study.py", "curves/mixture_likelihood/main.py",
                   "curves/mixture_likelihood/summarise.py", "profiler/main.py",
                   "uci/fetch_datasets.py", "uci/regression/launch_cpu_ranks.py",
                   "compare_onb_scaling.py", "audit_svgp.py",
                   "uci/classification/analyse_gap.py", "aggregate_seeds.py",
                   "make_results_summary.py"):
        assert f"experiments_torch/{module}" in names
    assert "scripts/results_cards.py" in names
