"""Time B1 (``spectral_train``) and B2 (``ard_gram_scaled``) of the PyTorch
port at the headline shape, for one checkout of the port.

    python3 scripts/b1_b2_breakdown.py [--root DIR] [--label NAME]

imports ``projected_langevin_sampling_torch`` from ``--root`` (default: this
checkout), so that two checkouts, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, can be timed in
turns on one card (parent, change, change, parent). The inputs are those of
``chip_smoke.py`` phases 2 and 3 (whose helpers it reuses from this
checkout): B1 for 20,000 steps at M=512, J=1000 with noise and without; B2
on k(Z, X), 512 x 5000, D=1, fp32. It also prints the op mix of B1's step
loop (``chip_smoke.step_loop_mix``). Needs one CUDA card; prints one JSON
line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("b1_b2_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from projected_langevin_sampling_torch.ops.cuda import build, gram
    from projected_langevin_sampling_torch.ops.cuda import spectral_train as spec

    # chip_smoke's helpers, from this checkout (the package is already bound)
    loader = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(smoke)

    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": torch.cuda.get_device_name(0)}
    # B1 as phase 3's timing: one run of 20,000 steps at the headline
    gen = torch.Generator(device="cuda").manual_seed(3)
    w0 = torch.randn((smoke.M, smoke.J), generator=gen, device="cuda")
    decay, shift, sigma, b = smoke._spectral_coeffs(smoke.M, 1e-4)
    kw = dict(eta=1e-4, patience=math.inf, e_const=0.0, num_steps=smoke.STEPS,
              noise_scale=math.sqrt(2e-4), seed=1)
    kinds = {"default": {}, "zero_noise": {"zero_noise": True}}

    def run(**extra):
        return spec.spectral_train(w0, decay, shift, sigma, b, **kw, **extra)

    build.build(("spectral_train", "gram"))
    out["b1"] = {"step_mix": smoke.b1_step_mixes(build.library_path("spectral_train"))}
    for name, extra in kinds.items():
        out["b1"][name] = {
            "call_ms": smoke.cuda_ms(lambda: run(**extra), reps=3),
            "device_ms": smoke.profiled_launch_ms(lambda: run(**extra), "spectral_train_kernel", 3)[0],
        }

    # B2 as phase 2's timing: k(Z, X) in fp32
    x, _, z = smoke.headline_inputs(torch.float32)
    a, bx = (z / 0.01).contiguous(), (x / 0.01).contiguous()
    out["b2"] = {
        "call_ms": smoke.cuda_ms(lambda: gram.ard_gram_scaled(a, bx, 1.0), reps=200, warmup=5),
        "device_ms": smoke.profiled_launch_ms(lambda: gram.ard_gram_scaled(a, bx, 1.0),
                                              "ard_gram", 200)[0],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
