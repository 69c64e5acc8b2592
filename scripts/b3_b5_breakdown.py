"""Time B3 (``general_train``), B4 (``quadratic_train``) and B5
(``fused_update``) of the PyTorch port at the headline shape, kernel by
kernel, for one checkout of the port.

    python3 scripts/b3_b5_breakdown.py [--root DIR] [--label NAME]

imports ``projected_langevin_sampling_torch`` from ``--root`` (default: this
checkout), so that two checkouts, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, can be timed in
turns on one card (parent, change, change, parent). The inputs are those of
``chip_smoke.py`` phases 6(e) and 9 (whose helpers it reuses from this
checkout): B3 on the headline classification cell (smoothed Bernoulli,
preconditioned, N=5000, M_k=512, J=1000, 200 steps with noise) and on the
same inputs with the Gaussian kind (the same products, a trivial epilogue), B4 on phase
8(e)'s runs (the IPB system non-shared and the ONB system shared, M=512,
J=1000, 20,000 steps with noise; call time only, which every checkout's B4
gives the same way) and B5 on the IPB matrix prior with the Bernoulli closed
form. Needs one CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B3_NAMES = ("forward_kernel", "update_kernel", "stop_kernel", "init_")
B5_NAMES = ("dc_kernel", "update_kernel")
T = 200


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("b3_b5_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import projected_langevin_sampling_torch as pt
    from projected_langevin_sampling_torch.ops.cuda import fused_update as fused
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen
    from projected_langevin_sampling_torch.ops.cuda import quadratic_train as quad
    from projected_langevin_sampling_torch.closed_forms import dc_kind_for_cost, general_fused_form

    # chip_smoke's helpers, from this checkout (the package is already bound)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": torch.cuda.get_device_name(0)}
    # B3 at the headline classification cell, as phase 6(e)
    x, labels, std, z = smoke.classification_inputs()
    basis = smoke.headline_basis(pt, x, z).replace(mean_constant=0.3)
    cost = pt.make_smoothed_bernoulli_cost(labels, std)
    kind, params, aux = general_fused_form(basis, cost)
    u0 = pt.PLS(basis, cost).initialise_particles(smoke.J, generator=0)
    b3 = dict(p=basis.train_projection, u0=u0, y=cost.y_train, eigenvalues=basis.eigenvalues,
              kind=kind, params=params, mean_shift=basis.mean_constant, aux=aux,
              eta=smoke.STEP_SIZE, patience=math.inf, num_steps=T,
              discretisation="preconditioned", seed=1)
    call_ms = smoke.cuda_ms(lambda: gen.general_train(**b3), reps=3)
    split = smoke.profiled_device_split(lambda: gen.general_train(**b3), B3_NAMES, 1)
    out["b3"] = {"call_ms_per_step": call_ms / T,
                 "device_ms_per_step": {k: None if v is None else v / T for k, v in split.items()}}
    # the same run with the Gaussian kind: the same products beside a trivial
    # epilogue, so the forward's difference from the smoothed kind's is the
    # GH16 quadrature
    gauss3 = dict(b3, kind="gaussian", params=(1.0, 0.0, 0.0))
    split = smoke.profiled_device_split(lambda: gen.general_train(**gauss3), B3_NAMES, 1)
    out["b3_gaussian"] = {
        "device_ms_per_step": {k: None if v is None else v / T for k, v in split.items()}}

    # B5 on the IPB matrix prior, Bernoulli, as phase 9's timed case
    xg, y, zg = smoke.headline_inputs(torch.float32)
    ipb = smoke.headline_ipb(pt, xg, zg)
    bern = pt.BernoulliCost(y_train=(y > 0).float())
    b5_kind, b5_params = dc_kind_for_cost(bern)
    u = ipb.initialise_particles(smoke.J, generator=1)
    noise = torch.randn((smoke.M, smoke.J), generator=torch.Generator(device="cuda").manual_seed(4),
                        device="cuda")
    b5_args = (ipb.train_projection, ipb.base_gram_induce_train.T, bern.y_train, u,
               smoke.M * ipb.inv_base_gram_induce, noise, b5_kind)
    b5_kw = dict(eta=smoke.STEP_SIZE, params=b5_params, mean_shift=0.3)
    call_ms = smoke.cuda_ms(lambda: fused.fused_update(*b5_args, **b5_kw), reps=20, warmup=2)
    split = smoke.profiled_device_split(lambda: fused.fused_update(*b5_args, **b5_kw), B5_NAMES,
                                        10)

    def host_ms(calls=20):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fused.fused_update(*b5_args, **b5_kw)
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e3 * elapsed / calls

    out["b5"] = {"call_ms": call_ms, "device_ms": split,
                 "host_ms_per_call": min(host_ms() for _ in range(3))}

    # B4 at the headline, as phase 8(e): non-shared (IPB) and shared (ONB)
    gauss = pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, device="cuda"))
    u0 = ipb.initialise_particles(smoke.J, generator=0)
    out["b4"] = {}
    for name, b4_basis in (("non_shared", ipb), ("shared", smoke.headline_basis(pt, xg, zg))):
        b4_args, b4_kw = smoke.quadratic_args(b4_basis, gauss)
        b4_kw = dict(b4_kw, eta=smoke.STEP_SIZE, patience=math.inf, num_steps=smoke.STEPS, seed=1)
        out["b4"][name] = {
            "call_ms": smoke.cuda_ms(lambda: quad.quadratic_train(*b4_args, u0, **b4_kw), reps=2)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
