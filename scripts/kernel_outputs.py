"""Run the unsharded calls of B1 (``spectral_train``), B3 (``general_train``),
B4 (``quadratic_train``) and B5 (``fused_update``) of one checkout of the
PyTorch port on fixed inputs, and save what they return, so that two
checkouts can be compared bit for bit on one card.

    python3 scripts/kernel_outputs.py --root DIR --out FILE
    python3 scripts/kernel_outputs.py --compare FILE_A FILE_B

imports ``projected_langevin_sampling_torch`` from ``--root`` (a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, or this checkout) and calls only arguments every checkout has. The
inputs are made on the card from seeds: B1 at M=512, J=1000, 20,000 steps
with its own noise; B3 (smoothed Bernoulli, preconditioned) and B4
(non-shared) at phase 6's and phase 8's shapes, each with infinite patience
and with a patience that stops inside the run; B5 on the matrix and the
diagonal prior at N=5000. ``--compare`` prints one JSON line with the keys
that differ and exits 1 if any does. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outputs(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    from projected_langevin_sampling_torch.ops.cuda import fused_update as fused
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen
    from projected_langevin_sampling_torch.ops.cuda import quadratic_train as quad
    from projected_langevin_sampling_torch.ops.cuda import spectral_train as spec

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    rand = lambda *s: torch.rand(s, generator=g, device="cuda")  # noqa: E731
    out = {}
    # B1
    m, j, eta = 512, 1000, 1e-4
    sigma = 1.0 + 99.0 * rand(m)
    b = randn(m)
    w0 = randn(m, j)
    res = spec.spectral_train(w0, 1 - eta * sigma, eta * b, sigma, b, eta=eta, patience=math.inf,
                              e_const=3.0, num_steps=20_000, noise_scale=math.sqrt(2 * eta),
                              seed=12345)
    out.update(b1_w=res[0], b1_e=res[1])
    # B3 at phase 6's shape
    n3, m3, j3 = 1000, 128, 256
    p = randn(n3, m3) * math.sqrt(2.0 / n3)
    lam = 0.5 + 1.5 * rand(m3)
    u0 = torch.sqrt(lam)[:, None] * randn(m3, j3)
    y = (rand(n3) > 0.5).float()
    aux = 0.3 + 0.9 * rand(n3)
    for label, patience in (("inf", math.inf), ("stop", 2e-3)):
        res = gen.general_train(p, u0, y, lam, "bernoulli_sigmoid_smoothed", eta=1e-3,
                                patience=patience, num_steps=200, aux=aux,
                                discretisation="preconditioned", seed=7)
        out.update({f"b3_{label}_u": res[0], f"b3_{label}_e": res[1],
                    f"b3_{label}_steps": res[3]})
    # B4, non-shared, at M=512, J=1000
    q, _ = torch.linalg.qr(randn(m, m))
    a = (q * (1.0 + rand(m))) @ q.T
    e = (q * (1.0 + rand(m))) @ q.T
    s = randn(m, m) / math.sqrt(m)
    b4 = (a, randn(m), e, randn(m), s, randn(m, j))
    for label, patience in (("inf", math.inf), ("stop", 2e-3)):
        res = quad.quadratic_train(*b4, eta=0.05, patience=patience, e_const=float(m),
                                   num_steps=2000, shared=False, seed=7)
        out.update({f"b4_{label}_u": res[0], f"b4_{label}_e": res[1],
                    f"b4_{label}_steps": res[3]})
    # B5 at N=5000
    n5 = 5000
    p5, d5 = randn(n5, m), randn(m, n5).T
    y5 = (rand(n5) > 0.5).float()
    u5, noise5 = randn(m, j), randn(m, j)
    g5 = randn(m, m)
    for label, prior in (("matrix", g5 @ g5.T / m), ("diag", 1.0 + rand(m))):
        out[f"b5_{label}"] = fused.fused_update(p5, d5, y5, u5, prior, noise5, "bernoulli_sigmoid",
                                                eta=1e-4, params=(1e-10, 0.0), mean_shift=0.3)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN where NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--out")
    parser.add_argument("--compare", nargs=2)
    args = parser.parse_args()
    if args.compare:
        first, second = (torch.load(path) for path in args.compare)
        differ = sorted(k for k in first if k not in second or not _same(first[k], second[k]))
        print(json.dumps({"compared": sorted(first), "differ": differ}))
        return 1 if differ else 0
    if not torch.cuda.is_available():
        print("kernel_outputs: no CUDA device", file=sys.stderr)
        return 1
    torch.save(_outputs(args.root), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
