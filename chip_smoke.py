"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Builds the six hand-written CUDA kernels from ``projected_langevin_sampling_torch/csrc``
with nvcc, holds each against its plain PyTorch version at the main paths'
shapes, and drives the main paths through the entry points a user calls,
each run with the launch counters set to 0 just before it and read just after:

- slice 1, ONB + Gaussian at N=5000, M=512, J=1000, fp32: build, 20000
  training steps on the spectral tier, chunked predict at N*=4096; then the
  README demo on the card;
- slice 2, bench.py's headline classification cell: the same basis, the
  residual-smoothed Bernoulli cost, the MAP mean constant, 2000 steps of
  the general kernel under the preconditioned discretisation, chunked
  predict and Bernoulli probabilities, then the same at a step size that
  converges; then the Euler Bernoulli cell;
- slice 3, bench.py's inducing-point cells on the same data: the build, 20000
  steps on the quadratic_fused tier (B4) and on the spectral tier (B1), each
  with a chunked predict; the Bernoulli cell through the W-space view on the
  general kernel (B3), and 2000 steps of ``langevin_steps`` on the Euler
  general body (B5 once per step);
- slice 4, the UCI regression protocol at kin8nm's shape (N=8192, D=8,
  fp64, split 80/10/10): B2's backward held to the plain version's autograd,
  an exact GP fitted on a 5000-row random subsample, an SVGP on M=81
  inducing points with its inducing inputs learned, Titsias's optimum, the
  ONB Gaussian PLS with Student-T extra predictive noise on B1, then
  TemperPLS, ConformalisePLS, TemperGP and ConformaliseGP with the test
  coverage of their 95% intervals; Dirichlet targets and a fixed-noise exact
  GP on slice 2's labels, and spread tempering of slice 2's trained model;
- slice 5 (phase 12), scale-out on a world-size-1 NCCL group and a 1 x 1
  mesh at the headline shape: 2000 ``parallel_langevin_steps`` on B5 (the
  injected-noise variant bit for bit ``langevin_steps``), B5's partial mode
  on two row halves against the fused step, ``parallel_train_pls`` on B1
  (bit for bit ``train_pls``, also at a patience that stops mid-run), B1,
  B3 and B4 on two column shards against the whole run, the mesh-sharded
  chunked predict against the single-device one, and the WDBC
  classification demo twin on the card;
- slice 6 (phase 13), the UCI harness (``experiments_torch``): the
  regression main on kin8nm (8192 rows) and the classification main on
  rice (3810 rows), synthetic data at the real row counts, the README's
  headline configs cut in depth only, fp64: all 12 (and 2) models' metric
  files, the conformal test coverage, pls-onb's test MSE and accuracy, and
  B1 and B2 (with its backward) launched inside the mains;
- slice 7 (phase 14), the curve mains of ``experiments_torch`` on curve 2
  at their configs' widths (N = 500 or 1000), depth cut, fp64, each in a
  fresh directory (``scripts/curve_mains.py``): the regression main on its
  Euler and preconditioned configs (pls-onb on B1, held to its plain
  version at the main's shapes and on its inputs), the classification main
  (four PLS models on the off tier and the SVGP), the Poisson main and one
  cell of its study, the mixture main and its summary (both modes kept, the
  shift estimated), and the profiler's sweeps of N, M, T and J in fp32 (PLS
  on B1 against the SVGP fit);
- slice 8 (phase 15), fp64, each piece in a fresh directory
  (``scripts/slice8_tools.py``): the real sklearn-bundled UCI sets from the
  repo's raw tables (shapes, and whether the JAX script's sha256 pins
  match); the regression main on diabetes_sklearn and the classification
  main on wine_uci and breast_wdbc; the gap attribution on the latter's
  checkpoints, every row through its validation gate; the SVGP audit on
  diabetes_sklearn and synthetic energy_cooling; the ONB-scaling comparison
  on two curves; and the regression main on config_parallel's protocol on a
  1 x 1 mesh over a world-size-1 NCCL group, whose pls* metric files equal
  the same main's without the mesh bit for bit. B1 is held to its plain
  version on each shape's first call;
- slice 9 (phase 16), the results pipeline: the regression main on
  diabetes_sklearn and the classification main on wine_uci over data seeds
  0-2 (pls-onb and svgp, the real short configs, fp64;
  ``scripts/results_cards.py``'s ``run_main``), then ``aggregate_seeds``
  (n = 3 in every test cell) and ``make_results_summary`` over their trees:
  both sets in the head-to-head and the real-data rollup, every per-seed
  value back exactly from the long CSV, the same tables from the long CSV
  alone, and pls-onb's per-seed test MSE and accuracy inside phase 15's
  limits;
- slice 11 (phase 18), the mixture main at its preconditioned config
  (GP epochs cut) on curve 1: its mode split, estimated shift and NLL held
  to the spread of the port's CPU runs of the same data over PLS seeds.

Phase 1 also reports whether the built B3, B4 and B5 libraries hold
tensor-core instructions (HMMA or HGMMA in ``cuobjdump -sass``), the tiling
of their products (``csrc/tc_product.cuh``, B3's ``update_plan``), and the
op mix of B1's step loop in its SASS; phase 2 runs each path of B2 (16-byte
stores, scalar stores at a ragged edge, the staged path for large D); phase
3 holds B1's draws to a CPU
mirror of its Philox and Box-Muller and a noisy run at the main path's noise
scale to the plain loop fed the mirror's normals, checks their tail, splits B1's device
time into its normals and the rest, and sets the op mix against the measured
time at the SM clock read beside the run; phases 6 and 9 split B3's and
B5's device time by kernel, phases 6, 8 and 9 give the bound on the tensor
cores beside the fp32 SIMT bound of earlier runs, phase 8 B4's launches per
run (one), its host enqueue and the device's idle share inside its call, and
phase 9 B5's host time per call. Phase 9b holds Q1, the smoothed-Bernoulli
quadrature of the ``off`` tier (port only), to its plain version at the rice
main's shape in fp64 and fp32, reruns it bitwise, splits its device time by
kernel, and counts its node loop's SASS for its bound; its launches are
those of phases 13-17, where the smoothed cost trains on the ``off`` tier.

A probe of CUDA's initialisation in a subprocess runs first (it raises on a
wedged GPU driver). Any failure raises; there is no CPU fallback.

Run: python3 chip_smoke.py        (needs one CUDA card, nvcc under CUDA_HOME)

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path, its error against the
plain version, its time, the plain version's time and its bound.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import runpy
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, full 700 W): HBM bytes/s, fp32
# operations/s outside the tensor cores, and dense TF32 flops/s on them
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# B1's MUFU normals against the exact pair at noise scale 1: r^2 = z0^2 +
# z1^2 within B1_R2_ABS + B1_R2_REL r^2 and the angle within B1_ANGLE of the
# mirror's (phase 3 (c) gives the reasons)
B1_R2_ABS, B1_R2_REL, B1_ANGLE = 2.0**-21, 2.0**-18, 2.0**-19
N, M, J = 5000, 512, 1000  # bench.py's headline shape
STEPS, STEP_SIZE, N_TEST, CHUNK = 20_000, 1e-4, 4096, 256


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, between CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_device_split(fn, kernel_names, reps: int, warmup: bool = True):
    """Device milliseconds per call of each of ``kernel_names``, the kernels
    whose names contain it (the first name that matches takes a kernel), from
    the profiler's CUDA activity; a name the trace shows no time for gets
    None."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = dict.fromkeys(kernel_names, 0.0)
    for e in prof.key_averages():
        name = next((k for k in kernel_names if k in e.key), None)
        if name is not None:
            total_us[name] += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    return {k: (us / 1e3 / reps if us > 0 else None) for k, us in total_us.items()}


def profiled_device_ms(fn, kernel_name, reps: int, warmup: bool = True):
    """Device milliseconds per call of the kernels whose names contain
    ``kernel_name`` (a name or a tuple of names); None if the trace shows no
    device time."""
    names = (kernel_name,) if isinstance(kernel_name, str) else tuple(kernel_name)
    split = profiled_device_split(fn, names, reps, warmup)
    return sum_measured(split)


def profiled_launch_ms(fn, kernel_name, reps):
    """Mean device milliseconds per launch of the kernels whose names contain
    ``kernel_name``, over ``reps`` calls of ``fn`` after one warm-up call, and
    the launches the profiler's trace shows; (None, 0) if it shows none. The
    mean is over the launches seen, so a trace that drops events (the
    profiler at times does) does not shrink it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for e in prof.key_averages():
        if kernel_name in e.key:
            total_us += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            launches += e.count
    return (total_us / 1e3 / launches if launches else None), launches


def profiled_kernel_count(fn):
    """The device kernels one call of ``fn`` runs, from the profiler's CUDA
    activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "cuda" in str(getattr(e, "device_type", "")).lower())


def sum_measured(split):
    """The sum of a profiled split, None if no part was measured."""
    parts = [v for v in split.values() if v is not None]
    return sum(parts) if parts else None


def split_text(split, per=1):
    """``name a ms, ...`` of a profiled split, each divided by ``per``."""
    return ", ".join(f"{k} {'not measured' if v is None else f'{v / per:.4f} ms'}"
                     for k, v in split.items())


def tc_bound(products_flops, elementwise_ops, nbytes):
    """The least time in ms of work whose fp32 products run as three TF32
    products on the tensor cores: the larger of those at 495 TFLOP/s, the
    elementwise operations at 67 TFLOP/s on the CUDA cores, and the bytes at
    3.35 TB/s; with the name of the larger term."""
    terms = {"tf32 products": 1e3 * 3 * products_flops / TF32_OPS_PER_S,
             "fp32 elementwise": 1e3 * elementwise_ops / FP32_OPS_PER_S,
             "bytes": 1e3 * nbytes / HBM_BYTES_PER_S}
    term = max(terms, key=terms.get)
    return terms[term], term


def sass_text(lib_path):
    """A built library's SASS (cuobjdump -sass), None where the toolkit has no
    cuobjdump."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    tool = os.path.join(cuda_home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=300).stdout


# Op-mix classes of a loop's SASS, by opcode (the text before the first '.')
SASS_CLASSES = {
    "IMAD": ("IMAD",),
    "LOP3/IADD": ("LOP3", "IADD3", "IADD", "SHF", "LEA", "IABS", "PRMT", "IMNMX", "SGXT"),
    "FFMA/FMUL/FADD": ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FCHK"),
    "MUFU": ("MUFU",),
    "I2F/F2I": ("I2F", "I2FP", "F2I", "F2F", "F2IP", "FRND"),
    "SHFL": ("SHFL",),
    "BAR": ("BAR",),
    "STS/STG": ("STS", "STG"),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC"),
}
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_SASS_TARGET = re.compile(r"(?:^|,)\s*0x([0-9a-f]+)\s*$")


def sass_functions(text):
    """``{mangled name: [(address, opcode, operands), ...]}`` of every function
    in a library's SASS."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            instr = _SASS_INSTR.search(line)
            if instr:
                cur.append((int(instr.group(1), 16), instr.group(3), instr.group(4)))
    return funcs


def innermost_loops(entries):
    """``[(first, last), ...]`` indices of a function's innermost loops: a
    backward branch with no other inside it."""
    index = {addr: i for i, (addr, _, _) in enumerate(entries)}
    loops = []
    for i, (_, op, args) in enumerate(entries):
        target = _SASS_TARGET.search(args) if op.startswith("BRA") else None
        start = index.get(int(target.group(1), 16), i) if target else i
        if start < i:  # a branch back: the loop from its target to here
            loops.append((start, i))
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]


def step_loop_mix(entries):
    """The op mix of a kernel's step loop: the innermost loop holding a warp
    shuffle, the largest if several (the compiler may split a loop on a
    flag). Steps per iteration: one a barrier where the loop holds barriers,
    else one a five-shuffle warp sum (five SHFL each). Returns ``{class:
    count per step, "other": ..., "total": ...}`` or None."""
    best = None
    for a, b in innermost_loops(entries):
        ops = [e[1].split(".")[0] for e in entries[a:b + 1]]
        if "SHFL" in ops and (best is None or len(ops) > len(best)):
            best = ops
    if best is None:
        return None
    steps = best.count("BAR") or max(1, best.count("SHFL") // 5)
    mix = {name: sum(op in codes for op in best) / steps for name, codes in SASS_CLASSES.items()}
    mix["total"] = len(best) / steps
    mix["other"] = mix["total"] - sum(v for k, v in mix.items() if k != "total")
    return mix


# B1's kernels by the noise they draw (csrc/spectral_train.cu, enum Noise),
# as their mangled names give the template argument
B1_KERNELS = {"NoiseE0E": "zero noise", "NoiseE1E": "MUFU normals"}


def b1_step_mixes(lib_path):
    """``{kernel: step-loop op mix}`` of every B1 kernel in a built library,
    named as in B1_KERNELS where the name says (else mangled); None without
    cuobjdump."""
    text = sass_text(lib_path)
    if text is None:
        return None
    return {next((v for k, v in B1_KERNELS.items() if k in name), name): step_loop_mix(entries)
            for name, entries in sass_functions(text).items() if "spectral_train_kernel" in name}


def mix_text(mix):
    return ", ".join(f"{k} {v:g}" for k, v in mix.items())


def headline_inputs(dtype):
    """bench.py's build(): sorted X on [-3, 3], Z = linspace, lengthscale 0.01."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, (N, 1)), axis=0)
    f_true = np.sin(2 * x[:, 0])
    y = f_true + 0.2 * rng.normal(size=N)
    z = np.linspace(-3, 3, M)[:, None]
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    return as_t(x), as_t(y), as_t(z)


# --------------------------------------------------------------------------
# phase 2: B2, the gram
# --------------------------------------------------------------------------
def phase_gram(gram):
    results = {}
    errs = []
    for dtype, rtol, atol in ((torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-6)):
        x, _, z = headline_inputs(dtype)
        gen = torch.Generator(device="cuda").manual_seed(1)
        ragged1 = torch.randn((333, 7), generator=gen, dtype=dtype, device="cuda")
        ragged2 = torch.randn((1001, 7), generator=gen, dtype=dtype, device="cuda")
        wide1 = torch.randn((333, 20), generator=gen, dtype=dtype, device="cuda") / 2
        wide2 = torch.randn((1001, 20), generator=gen, dtype=dtype, device="cuda") / 2
        # each path of csrc/gram.cu: registers and 16-byte stores (D <= 8, N2 a
        # multiple of the strip), registers and scalar stores (a ragged N2),
        # and the staged path (D > 8)
        cases = {
            "k(Z,X) 512x5000 D=1, 16-byte stores": (z / 0.01, x / 0.01, False),
            "k(Z,X) 512x4999 D=1, scalar stores": (z / 0.01, x[:4999] / 0.01, False),
            "ragged 333x1001 D=7, scalar stores": (ragged1, ragged2, False),
            "same k(Z,Z) 512x512 D=1, 16-byte stores": (z / 0.01, z / 0.01, True),
            "same ragged 333x333 D=7, scalar stores": (ragged1, ragged1, True),
            "staged 333x1001 D=20": (wide1, wide2, False),
            "same staged 333x333 D=20": (wide1, wide1, True),
        }
        for name, (a, b, same) in cases.items():
            a, b = a.contiguous(), b.contiguous()
            got = gram.ard_gram_scaled(a, b, 1.3, same=same)
            plain = gram.ard_gram_scaled_reference(a, b, 1.3, same=same)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            ok = torch.allclose(got, plain, rtol=rtol, atol=atol)
            log(f"  B2 {dtype} {name}: max|kernel - plain| = {err:.3e} ({'ok' if ok else 'FAIL'})")
            require(ok, f"gram kernel disagrees with its plain version: {dtype} {name}")
            if same:
                require(bool((torch.diagonal(got) == 1.3).all()), f"same-input diagonal {name}")
            if name.startswith("k(Z,X)") and dtype == torch.float32:
                errs.append(err)
    # time at the main path's largest gram, k(Z, X) in fp32
    x, _, z = headline_inputs(torch.float32)
    a, b = (z / 0.01).contiguous(), (x / 0.01).contiguous()
    ms = cuda_ms(lambda: gram.ard_gram_scaled(a, b, 1.0), reps=200, warmup=5)
    plain_ms = cuda_ms(lambda: gram.ard_gram_scaled_reference(a, b, 1.0), reps=50, warmup=2)
    dev_ms, seen = profiled_launch_ms(lambda: gram.ard_gram_scaled(a, b, 1.0), "ard_gram", 200)
    log(f"  B2 device time k(Z,X) fp32 (profiler, mean of {seen} launches seen of 200): "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")
    out_bytes = 4 * M * N
    in_bytes = 4 * (a.numel() + b.numel())
    ops = M * N * 9  # norms add, 2*cross, sub, clamp, 2 scalings, exp (~2)
    bound_bytes_ms = 1e3 * (out_bytes + in_bytes) / HBM_BYTES_PER_S
    bound_ops_ms = 1e3 * ops / FP32_OPS_PER_S
    results.update(
        ms=ms, plain_ms=plain_ms, max_abs_err=max(errs),
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
    )
    log(f"  B2 time k(Z,X) fp32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {results['bound_ms']:.4f} ms ({results['bound_by']})")
    return results


# --------------------------------------------------------------------------
# phase 3: B1, the spectral trainer
# --------------------------------------------------------------------------
def _spectral_coeffs(m, eta, rising=False, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")  # noqa: E731
    sigma = 1.0 + 99.0 * rand(m)  # eta * sigma in [0.01, 1] for eta = 0.01
    b = torch.randn((m,), generator=gen, device="cuda")
    if rising:
        b = -b.abs()
        decay = 1.0 + eta * sigma
    else:
        decay = 1.0 - eta * sigma
    return decay, eta * b, sigma, b


def hold_spectral_zero_noise(spec, w0, num_steps, label, eta=0.01):
    """B1 without noise against the plain loop, both fp32, from ``w0`` for
    ``num_steps`` steps on the synthetic coefficients of its row count:
    W within rtol 1e-5, atol 1e-6 and the energies within rtol 1e-4 (the
    same update and sums in another order), every step run and recorded."""
    decay, shift, sigma, b = _spectral_coeffs(w0.shape[0], eta)
    kw = dict(eta=eta, patience=math.inf, e_const=12.5, num_steps=num_steps,
              noise_scale=math.sqrt(2 * eta), zero_noise=True)
    w_k, e_k, rec_k, steps_k = spec.spectral_train(w0, decay, shift, sigma, b, **kw)
    w_p, e_p, rec_p, steps_p = spec.spectral_train_reference(w0, decay, shift, sigma, b, **kw)
    torch.cuda.synchronize()
    err_w = float((w_k - w_p).abs().max())
    err_e = float(((e_k - e_p).abs() / e_p.abs()).max())
    log(f"  {label}: max|dW| = {err_w:.3e}, max rel dE = {err_e:.3e}")
    require(torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-6), f"{label}: spectral W disagrees")
    require(torch.allclose(e_k, e_p, rtol=1e-4), f"{label}: spectral energies disagree")
    require(int(steps_k) == int(steps_p) == num_steps and bool(rec_k.all()),
            f"{label}: spectral steps")


def phase_spectral(spec, b1_mixes):
    eta, m, j = 0.01, M, J
    gen = torch.Generator(device="cuda").manual_seed(3)
    w0 = torch.randn((m, j), generator=gen, device="cuda")
    res = {}

    # (a) zero noise against the plain loop
    hold_spectral_zero_noise(spec, w0, 2000, "B1 (a) zero noise T=2000")

    # (b) rising energy: the stop is fixed by patience / eta
    decay, shift, sigma, b = _spectral_coeffs(m, eta, rising=True)
    w_pos = w0.abs() + 1.0
    kw = dict(eta=eta, patience=0.055, e_const=0.0, num_steps=200,
              noise_scale=math.sqrt(2 * eta), zero_noise=True)
    launches = spec.spectral_train.launches
    w_k, e_k, rec_k, steps_k = spec.spectral_train(w_pos, decay, shift, sigma, b, **kw)
    require(spec.spectral_train.launches - launches == 2, "the stop did not take the rerun pass")
    w_p, e_p, rec_p, steps_p = spec.spectral_train_reference(w_pos, decay, shift, sigma, b, **kw)
    torch.cuda.synchronize()
    require(int(steps_k) == int(steps_p) == 7, f"stop step {int(steps_k)} vs {int(steps_p)}")
    require(bool((rec_k == rec_p).all()), "recorded flags disagree")
    require(bool((torch.isnan(e_k) == torch.isnan(e_p)).all()), "NaN tail disagrees")
    require(torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-6), "frozen particles disagree")
    log(f"  B1 (b) rising-energy stop: steps_run {int(steps_k)} (plain {int(steps_p)}), "
        "recorded flags, NaN tail and frozen particles agree")
    # the rerun reproduces the Philox draws: a noisy run that stops equals a
    # run of exactly steps_run steps from the same seed
    kw_noisy = dict(kw, zero_noise=False, seed=77)
    w_stop, _, _, s_stop = spec.spectral_train(w_pos, decay, shift, sigma, b, **kw_noisy)
    kw_exact = dict(kw_noisy, patience=math.inf, num_steps=int(s_stop))
    w_exact, _, _, _ = spec.spectral_train(w_pos, decay, shift, sigma, b, **kw_exact)
    require(bool(torch.equal(w_stop, w_exact)), "rerun did not reproduce the Philox draws")
    log(f"  B1 (b) noisy stop at {int(s_stop)} steps reproduces the same draws on rerun")

    # (c) the draws: W after one step from 0 with decay = shift = 0 and noise
    # scale 1
    ones = torch.ones(5000, device="cuda")
    w_z = torch.zeros((5000, 1000), device="cuda")

    def draws(**kw):
        return spec.spectral_train(w_z, 0 * ones, 0 * ones, ones, 0 * ones, eta=eta,
                                   patience=math.inf, e_const=0.0, num_steps=1, noise_scale=1.0,
                                   seed=5, **kw)[0]

    eps = draws()
    mean, var = float(eps.double().mean()), float(eps.double().var())
    log(f"  B1 (c) 5e6 Philox normals: mean {mean:.2e}, variance {var:.5f}")
    require(abs(mean) < 5e-3 and abs(var - 1) < 5e-3, "Philox normals off N(0, 1)")
    # the tail: P(|z| > 4) = 6.334e-5, a count of 316.7 in 5e6 with a spread of 17.8
    n_eps, p_tail = eps.numel(), math.erfc(4 / math.sqrt(2))
    tail = int((eps.abs() > 4).sum())
    tail_sd = math.sqrt(n_eps * p_tail * (1 - p_tail))
    log(f"  B1 (c) |z| > 4: {tail} of {n_eps} draws, share {tail / n_eps:.4e} against "
        f"{p_tail:.4e} ({(tail - n_eps * p_tail) / tail_sd:+.2f} spreads)")
    require(abs(tail - n_eps * p_tail) <= 5 * tail_sd, "the normals' tail is off")
    # against the CPU mirror (Philox and Box-Muller in fp64) on the first 1e6
    # elements. The kernel's MUFU normals (fast_pair in csrc/spectral_train.cu),
    # pair by pair: r^2 = z0^2 + z1^2 within B1_R2_ABS + B1_R2_REL r^2 (log2:
    # 2^-22 absolute on [0.5, 1], 2 ulp below; times 2 ln 2, and the clamp at
    # 0; the root 1 ulp; sin and cos 2^-21 absolute each, so cos^2 + sin^2
    # within 2^-19.5 of 1; the products' rounding), and the angle atan2(z1,
    # z0) within B1_ANGLE (2 pi u2 - pi rounded in fp32, 2^-20.8; the sin and
    # cos errors, 2^-20.6) where r^2 > 2^-18 (at r = 0, from u1 = 1, there is
    # no angle).
    n_mirror = 10**6
    groups = np.arange(n_mirror // 4)
    r2_m, th_m = (a.reshape(-1) for a in spec.mirror_box_muller(5, groups, 0))
    z_k = eps.flatten()[:n_mirror].double().cpu().numpy().reshape(-1, 2)
    r2_k, th_k = z_k[:, 0] ** 2 + z_k[:, 1] ** 2, np.arctan2(z_k[:, 1], z_k[:, 0])
    r2_ratio = float(np.max(np.abs(r2_k - r2_m) / (B1_R2_ABS + B1_R2_REL * r2_m)))
    d_th = np.abs(np.remainder(th_k - th_m + math.pi, 2 * math.pi) - math.pi)[r2_m > 2.0**-18]
    th_ratio = float(np.max(d_th) / B1_ANGLE)
    log(f"  B1 (c) against the CPU mirror over {n_mirror} draws (largest error over its "
        f"tolerance): r^2 {r2_ratio:.3f}, angle {th_ratio:.3f}; largest |r^2 error| "
        f"{float(np.max(np.abs(r2_k - r2_m))):.3e}, |angle error| {float(np.max(d_th)):.3e}")
    require(r2_ratio <= 1 and th_ratio <= 1, "the kernel's normals disagree with the mirror")

    decay, shift, sigma, b = _spectral_coeffs(m, eta, seed=9)
    w_t, _, _, _ = spec.spectral_train(w0, decay, shift, sigma, b, eta=eta, patience=math.inf,
                                       e_const=0.0, num_steps=5000,
                                       noise_scale=math.sqrt(2 * eta), seed=11)
    law_mean = b / sigma
    law_var = 2.0 / (sigma * (2.0 - eta * sigma))
    z_mean = (w_t.mean(1) - law_mean) / torch.sqrt(law_var / j)
    z_var = (w_t.var(1) - law_var) / (law_var * math.sqrt(2.0 / (j - 1)))
    z_max = float(torch.max(z_mean.abs().max(), z_var.abs().max()))
    log(f"  B1 (c) stationary law over {m} rows, J={j}, T=5000: max |z| = {z_max:.2f}")
    require(z_max < 6, "rows do not follow the Euler stationary law")
    res["max_abs_err"] = phase_spectral_noisy(spec, w0)

    # time at the main path's shape: one whole run of 20000 steps
    decay, shift, sigma, b = _spectral_coeffs(m, 1e-4)
    kw = dict(eta=1e-4, patience=math.inf, e_const=0.0, num_steps=STEPS,
              noise_scale=math.sqrt(2e-4))

    def run(**extra):
        return spec.spectral_train(w0, decay, shift, sigma, b, seed=1, **kw, **extra)

    res["ms"] = cuda_ms(run, reps=3)
    res["plain_ms"] = cuda_ms(
        lambda: spec.spectral_train_reference(w0, decay, shift, sigma, b, **kw), reps=1, warmup=0
    )
    # device time with the kernel's normals and with none: the second is the
    # update, the energy, the reduction and the barriers
    dev, seen = {}, {}
    for name, extra in (("MUFU normals", {}), ("zero noise", {"zero_noise": True})):
        dev[name], seen[name] = profiled_launch_ms(lambda: run(**extra), "spectral_train_kernel", 3)
    log(f"  B1 device time T={STEPS} (profiler, mean of the launches seen of 3, one a run): "
        + ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'} ({seen[k]} seen)"
                    for k, v in dev.items()))
    elem_steps = m * j * STEPS
    bound_ops_ms = 1e3 * elem_steps * spec.OPS_PER_ELEMENT_STEP / FP32_OPS_PER_S
    bound_bytes_ms = 1e3 * 4 * (2 * m * j + 4 * m + STEPS) / HBM_BYTES_PER_S
    res["bound_ms"] = max(bound_ops_ms, bound_bytes_ms)
    res["bound_by"] = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    log(f"  B1 time M={m} J={j} T={STEPS}: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.1f} ms, bound {res['bound_ms']:.3f} ms ({res['bound_by']}, "
        f"{spec.OPS_PER_ELEMENT_STEP} ops per element-step)")

    # instruction slots: the step loop's SASS a step (phase 1) against the
    # measured time, at the SM clock sampled beside the run; an SM dispatches
    # 4 warp instructions a clock (128 thread slots) and 16 MUFU results a clock
    mhz = sampled_sm_clock_mhz(run, seconds=2.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  SM clock under B1 (nvidia-smi, median): "
        f"{'not measured' if mhz is None else f'{mhz:.0f} MHz'}; {sms} SMs")
    for name, mix in (b1_mixes or {}).items():
        if mix is None or mhz is None or name not in dev:
            continue
        slots = mix["total"] / spec.ELEMENTS_PER_THREAD
        clocks = 1e3 * elem_steps / (sms * mhz * 1e6)  # ms per clock-per-element-step an SM
        measured = dev[name]
        log(f"  B1 instruction-slot estimate, {name}: {slots:.2f} slots an element-step -> "
            f"{clocks * slots / 128:.3f} ms dispatching, {clocks * mix['MUFU'] / spec.ELEMENTS_PER_THREAD / 16:.3f} "
            f"ms on the MUFU pipe; measured "
            + ("not measured" if measured is None else
               f"{measured:.3f} ms = {128 * measured / clocks:.1f} slots an element-step")
            + f"; the bound counts {spec.OPS_PER_ELEMENT_STEP} operations")
    return res


def phase_spectral_noisy(spec, w0, steps=64, seed=21, eta=1e-4, coeffs=None, noise_scale=None,
                         label="B1 (d) noisy"):
    """(d) B1 as the main path runs it, its MUFU normals at the noise scale
    sqrt(2 eta), for ``steps`` steps at the headline M, J, against the plain
    loop in fp64 fed the mirror's exact normals of the same seed
    (``spectral_train.mirror_noise``); returns max |W - W_plain|. With
    ``coeffs`` (decay, shift, sigma, b) and ``noise_scale`` it runs those of
    a main path's call, ``w0`` that call's particles, both in fp32.

    Tolerance, elementwise and step by step: a draw s z is off by at most
    s (r - sqrt(max(r^2 - e, 0)) + (r + sqrt(e)) B1_ANGLE) with e = B1_R2_ABS
    + (B1_R2_REL + 2^-22) r^2, the vector of (c)'s r^2 and angle tolerances
    (2^-22 more for the noise scale rounded to fp32 and folded into r^2 by two
    more roundings); the update's three fp32 roundings add 2^-24 of each
    intermediate's size, and an error carries to the next step times |decay|.
    An energy is off by at most the sum over elements of |sigma w - b| dW +
    sigma dW^2 / 2 and of the fp32 sums' rounding: at most 300 adds in a row
    (8 a thread, 5 a warp, 8 a block, the blocks' sum) of 2^-24 of the terms'
    sizes, over J."""
    m, j = w0.shape
    decay, shift, sigma, b = _spectral_coeffs(m, eta) if coeffs is None else coeffs
    s = math.sqrt(2 * eta) if noise_scale is None else noise_scale
    kw = dict(eta=eta, patience=math.inf, e_const=0.0, num_steps=steps, noise_scale=s)
    w_k, e_k, _, _ = spec.spectral_train(w0, decay, shift, sigma, b, seed=seed, **kw)
    noise = torch.from_numpy(spec.mirror_noise(seed, m, j, steps)).cuda()
    w0_d, d, sh, sg, bb = (t.double() for t in (w0, decay, shift, sigma, b))
    eye = torch.eye(m, dtype=torch.float64, device="cuda")
    w_p, e_p, _, _ = spec.spectral_train_reference(w0_d, d, sh, sg, bb, noise=noise, q_in=eye,
                                                   **kw)
    # the bounds, along the same recursion in fp64
    u = 2.0**-24
    d, sh, sg, bb = d[:, None], sh[:, None], sg[:, None], bb[:, None]
    w, dw_max = w0_d, torch.zeros_like(w0_d)
    de_max = torch.empty(steps, dtype=torch.float64, device="cuda")
    for t in range(steps):
        z = noise[t]
        r2 = (z.reshape(-1, 2) ** 2).sum(1, keepdim=True).expand(-1, 2).reshape(m, j)
        e = B1_R2_ABS + (B1_R2_REL + 2.0**-22) * r2
        r = r2.sqrt()
        draw = s * (r - (r2 - e).clamp(min=0).sqrt() + (r + e.sqrt()) * B1_ANGLE)
        dw = d * w
        w = dw + sh + s * z
        dw_max = d.abs() * dw_max + draw + u * (dw.abs() + (dw + sh).abs() + w.abs() + 3 * dw_max)
        sizes = (w.abs() + dw_max) * (0.5 * sg * (w.abs() + dw_max) + bb.abs())
        de_max[t] = (((sg * w - bb).abs() * dw_max + 0.5 * sg * dw_max**2).sum()
                     + 301 * u * sizes.sum()) / j
    require(torch.allclose(w, w_p, rtol=1e-12, atol=0.0),
            "the bound's recursion is not the plain loop's")
    de_max += u * e_p.abs()  # the division by J in fp32
    err_w, err_e = (w_k.double() - w_p).abs(), (e_k.double() - e_p).abs()
    ratio_w, ratio_e = float((err_w / dw_max).max()), float((err_e / de_max).max())
    log(f"  {label}, M={m}, J={j}, T={steps} at noise scale {s:.4g}, against the plain loop "
        f"on the mirror's normals: max|dW| = {float(err_w.max()):.3e} ({ratio_w:.3f} of its bound, "
        f"largest bound {float(dw_max.max()):.3e}), max|dE| = {float(err_e.max()):.3e} "
        f"({ratio_e:.3f} of its bound)")
    require(ratio_w <= 1, f"{label}: B1 disagrees with the plain loop on the mirror's normals")
    require(ratio_e <= 1, f"{label}: B1's energies disagree with the plain loop's")
    return float(err_w.max())


def sampled_sm_clock_mhz(fn, seconds):
    """The median SM clock in MHz that nvidia-smi reads every 100 ms while
    ``fn`` runs over and over for ``seconds``; None without a reading."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    readings = []
    for line in out.splitlines()[1:]:  # the first may predate the load
        try:
            readings.append(float(line))
        except ValueError:
            pass
    return float(np.median(readings)) if readings else None


# --------------------------------------------------------------------------
# phase 4: the main path at the headline width
# --------------------------------------------------------------------------
def phase_main_path(pt, gram, spec):
    x, y, z = headline_inputs(torch.float32)
    gram.ard_gram_scaled.launches = 0
    spec.spectral_train.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel = pt.PLSKernel(
        base_kernel=pt.ARDKernel(
            lengthscales=torch.tensor([0.01], device="cuda"),
            outputscale=torch.tensor(1.0, device="cuda"),
        ),
        approximation_samples=x,
    )
    basis = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    require(basis.approximation_dimension == M, f"M_k = {basis.approximation_dimension}")
    pls = pt.PLS(basis, pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, device="cuda")))
    particles = pls.initialise_particles(J, generator=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # fast_path "auto" resolves to the spectral tier (and warns that a seed
    # gives another sample path than the off tier)
    trained, energies = pt.train_pls(pls, particles, STEPS, STEP_SIZE, generator=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    x_test = torch.linspace(-3, 3, N_TEST, device="cuda")[:, None]
    samples = pls.predict_samples(trained, x_test, generator=0, chunk_size=CHUNK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {"gram": gram.ard_gram_scaled.launches, "spectral": spec.spectral_train.launches}

    require(launches["spectral"] == 1, f"train_pls launched B1 {launches['spectral']} times")
    require(launches["gram"] >= 2, "the build did not launch the gram kernel")
    require(len(energies) == STEPS and all(math.isfinite(e) for e in energies), "energies")
    require(energies[-1] < energies[0], "energy did not fall")
    require(tuple(samples.shape) == (N_TEST, J) and bool(torch.isfinite(samples).all()),
            "predicted samples")
    rmse = float(torch.sqrt(torch.mean((samples.mean(1) - torch.sin(2 * x_test[:, 0])) ** 2)))
    train_s = t2 - t1
    log(f"  build {1e3 * (t1 - t0):.1f} ms; train_pls {STEPS} steps {1e3 * train_s:.1f} ms = "
        f"{1e3 * train_s / STEPS:.5f} ms/step, {STEPS / train_s:.1f} updates/s; "
        f"predict N*={N_TEST} chunk {CHUNK}: {1e3 * (t3 - t2):.1f} ms")
    log(f"  energy {energies[0]:.2f} -> {energies[-1]:.2f}; predictive-mean RMSE vs "
        f"sin(2x) {rmse:.4f}; launches {launches}")

    # where the time goes, outside the counted run: the spectral system
    # (P^T P on the card, fp64 eigh on the host) and the chunked predict's
    # batched eigh of (blocks, M + c, M + c)
    from projected_langevin_sampling_torch.ops.linalg import psd_sqrt
    from projected_langevin_sampling_torch.training import spectral_system_host

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - start) / reps

    system_ms = host_ms(lambda: spectral_system_host(basis, pls.cost))
    a = torch.randn((N_TEST // CHUNK, M + CHUNK, M + CHUNK), device="cuda")
    eigh_ms = host_ms(lambda: psd_sqrt(a @ a.transpose(-1, -2)))
    log(f"  breakdown: spectral_system_host {system_ms:.1f} ms; batched eigh "
        f"({N_TEST // CHUNK}, {M + CHUNK}, {M + CHUNK}) fp32 {eigh_ms:.1f} ms")
    return launches


# --------------------------------------------------------------------------
# phase 6: B3, the general-cost trainer
# --------------------------------------------------------------------------
N6, M6, J6, T6, ETA6 = 1000, 128, 256, 200, 1e-3  # the shape of the comparisons
# kernel against plain version, both fp32 with sums in another order: 200
# contracting steps keep the difference near fp32 rounding of |W|
W_TOL, E_RTOL = 1e-3, 1e-5
B3_KERNELS = ("forward_kernel", "update_kernel", "stop_kernel", "init_run_kernel")


def synthetic_general(kind, n=N6, m_k=M6, j=J6, seed=0):
    """general_train's arguments for a problem of cost ``kind``: a dense
    random projection with P^T P about 2 I, prior eigenvalues uniform(0.5, 2),
    prior draws as U0, and targets of f = sin(2x) on sorted x in [-3, 3]. The
    Poisson square link trains at a mean shift of 3 from small particles, so
    that F stays away from its pole at 0."""
    from projected_langevin_sampling_torch.ops.cuda.general_train import JITTER

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    f = np.sin(2 * np.sort(rng.uniform(-3, 3, n)))
    labels = (f + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    p = torch.randn((n, m_k), generator=gen, device="cuda") * math.sqrt(2.0 / n)
    lam = 0.5 + 1.5 * torch.rand(m_k, generator=gen, device="cuda")
    u0 = torch.sqrt(lam)[:, None] * torch.randn((m_k, j), generator=gen, device="cuda")
    params, mean_shift, aux = (0.0, 0.0, 0.0), 0.0, None
    if kind == "gaussian":
        y, params = f + 0.1 * rng.normal(size=n), (0.1, 0.0, 0.0)
    elif kind in ("bernoulli_sigmoid", "bernoulli_probit"):
        y, params = labels, (JITTER, 0.0, 0.0)
    elif kind == "bernoulli_sigmoid_smoothed":
        y, aux = labels, rng.uniform(0.3, 1.2, n)
    elif kind == "poisson_square":
        y, mean_shift, u0 = rng.poisson((3.0 + f) ** 2).astype(np.float64), 3.0, 0.2 * u0
    elif kind == "student_t":
        y, params = f + 0.1 * rng.standard_t(4.0, size=n), (4.0, 0.3, 0.0)
    elif kind == "multimodal_identity":
        y, params = f - 2.0 * (rng.uniform(size=n) < 0.4), (0.3, 2.0, 0.4)
    else:
        raise ValueError(kind)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    return dict(p=p, u0=u0, y=as_t(y), eigenvalues=lam, kind=kind, params=params,
                mean_shift=mean_shift, aux=None if aux is None else as_t(aux))


def hold_zero_noise(label, kernel, plain, what, *args, **kw):
    """A trainer kernel against its plain version with zero noise; returns
    (max|dU|, max rel dE)."""
    u_k, e_k, rec_k, s_k = kernel(*args, **kw, zero_noise=True)
    u_p, e_p, rec_p, s_p = plain(*args, **kw, zero_noise=True)
    torch.cuda.synchronize()
    err_w = float((u_k - u_p).abs().max())
    err_e = float(((e_k - e_p).abs() / e_p.abs()).max())
    scale = max(1.0, float(u_p.abs().max()))
    log(f"  {label} {what:<44s} max|dU| {err_w:.3e} (max|U| {scale:.2f}), max rel dE "
        f"{err_e:.3e}, E {float(e_p[0]):.4e} -> {float(e_p[-1]):.4e}")
    require(err_w <= W_TOL * scale, f"{label} particles disagree: {what}")
    require(err_e <= E_RTOL, f"{label} energies disagree: {what}")
    require(int(s_k) == int(s_p) == kw["num_steps"] and bool(rec_k.all()),
            f"{label} steps: {what}")
    return err_w, err_e


def hold_stop(label, kernel, plain, what, *args, **kw):
    """A run that stops: the same stop step, recorded flags, NaN tail and
    frozen particles as the plain version."""
    u_k, e_k, rec_k, s_k = kernel(*args, **kw, zero_noise=True)
    u_p, e_p, rec_p, s_p = plain(*args, **kw, zero_noise=True)
    torch.cuda.synchronize()
    require(1 < int(s_k) == int(s_p) < kw["num_steps"],
            f"{what}: steps_run {int(s_k)} vs plain {int(s_p)}")
    require(bool((rec_k == rec_p).all()), f"{what}: recorded flags disagree")
    require(bool((torch.isnan(e_k) == torch.isnan(e_p)).all()), f"{what}: NaN tail disagrees")
    # frozen at the stop step, whose entries may be huge or overflowed: the
    # same non-finite entries, and the finite ones normwise (an entry may be a
    # near-cancelling sum of growing modes, so elementwise relative errors mean
    # nothing there)
    finite = torch.isfinite(u_p)
    require(bool((finite == torch.isfinite(u_k)).all())
            and bool((torch.isnan(u_k) == torch.isnan(u_p)).all())
            and bool((u_k[~finite & ~torch.isnan(u_p)] == u_p[~finite & ~torch.isnan(u_p)]).all()),
            f"{what}: non-finite frozen particles disagree")
    require(bool(finite.any()), f"{what}: no finite particles to compare")
    scale = float(u_p[finite].abs().max())
    err = float((u_k[finite] - u_p[finite]).abs().max())
    require(err <= 1e-4 * scale, f"{what}: frozen particles disagree ({err:.3e} of {scale:.3e})")
    log(f"  {label} {what}: steps_run {int(s_k)} (plain {int(s_p)}), recorded flags and NaN "
        f"tail agree; frozen particles max|dU| {err:.3e} of max|U| {scale:.3e}, "
        f"{int((~finite).sum())} non-finite entries in both")


def drift_system(prob):
    """fp64 A = P^T P / s + diag(1 / lambda) and b = P^T (y - m0) / s of a
    Gaussian problem."""
    p64, s = prob["p"].double(), prob["params"][0]
    a = p64.T @ p64 / s + torch.diag(1.0 / prob["eigenvalues"].double())
    b = p64.T @ (prob["y"].double() - prob["mean_shift"]) / s
    return a, b


def classification_inputs():
    """bench.py's build() of the smoothed Bernoulli cell: the headline X and Z,
    labels f_true + 0.2 noise > 0, smoothing stds uniform(0.3, 1.2)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, (N, 1)), axis=0)
    labels = (np.sin(2 * x[:, 0]) + 0.2 * rng.normal(size=N) > 0).astype(np.float64)
    std = rng.uniform(0.3, 1.2, N)
    z = np.linspace(-3, 3, M)[:, None]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    return as_t(x), as_t(labels), as_t(std), as_t(z)


def headline_basis(pt, x, z):
    kernel = pt.PLSKernel(
        base_kernel=pt.ARDKernel(
            lengthscales=torch.tensor([0.01], device="cuda"),
            outputscale=torch.tensor(1.0, device="cuda"),
        ),
        approximation_samples=x,
    )
    basis = pt.build_orthonormal_basis(kernel, z, x, verbose=False)
    require(basis.approximation_dimension == M, f"M_k = {basis.approximation_dimension}")
    return basis


def phase_general(pt, gen):
    from projected_langevin_sampling_torch.closed_forms import general_fused_form
    from projected_langevin_sampling_torch.ops.cuda.cost_forms import COST_KINDS
    from projected_langevin_sampling_torch.utils.columns import ColumnShard

    b3 = ("B3", gen.general_train, gen.general_train_reference)
    res = {}
    # (a) zero noise: every cost kind under every discretisation
    for kind in COST_KINDS:
        prob = synthetic_general(kind)
        for disc in gen.DISCRETISATIONS:
            hold_zero_noise(*b3, f"{kind}/{disc} N={N6} M_k={M6} J={J6} T={T6}", **prob,
                         eta=ETA6, patience=math.inf, num_steps=T6, discretisation=disc)

    # ... the smoothed kind's branch-free reciprocal and log1p are the library's
    # division and log1pf on every float each takes
    require(gen.check_math() == (0, 0), f"B3 branch-free twins differ: {gen.check_math()}")
    log("  B3 branch-free reciprocal and log1p: the library's bits on every float each takes "
        "(1,056,964,608 and 2,139,095,040)")

    # ... the products' operands, split once on the card, are the plain split's
    # bit for bit (the headline's and rice's shapes: M_k 512 and 55, padded;
    # N 5000 and 3048, padded for the update)
    for n, m_k, j in ((N, M, J), (3048, 55, 1000)):
        p = torch.randn((n, m_k), device="cuda")
        u = torch.randn((m_k, j), device="cuda")
        k, depth = gen.forward_plan(n, m_k, j).k, gen.update_plan(n, m_k, j).depth
        on_card = (*gen.split_operands(p, u, k), gen.split_update_operand(p, k, depth))
        plain = (*gen.split_operands_reference(p, u, k),
                 gen.split_update_operand_reference(p, k, depth))
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(on_card, plain)), f"split operands at {(n, m_k, j)}")
    log("  B3 forward and update operands split on the card are the plain split's bit for bit "
        f"(N, M_k, J) = {(N, M, J)} and (3048, 55, 1000)")

    # ... a ragged depth at rice's shape (M_k = 55, padded to 64), and a shard of
    # columns that starts past column 0
    prob = synthetic_general("bernoulli_sigmoid_smoothed", n=3048, m_k=55, j=1000, seed=2)
    hold_zero_noise(*b3, "bernoulli_sigmoid_smoothed/preconditioned N=3048 M_k=55 J=1000 "
                    f"T={T6}", **prob, eta=ETA6, patience=math.inf, num_steps=T6,
                    discretisation="preconditioned")
    prob = synthetic_general("student_t", seed=3)
    shard = ColumnShard(j0=128, j_total=3 * J6)
    hold_zero_noise(*b3, f"student_t/exponential shard j0=128 of J={3 * J6} T={T6}", **prob,
                    eta=ETA6, patience=math.inf, num_steps=T6, discretisation="exponential",
                    shard=shard)

    # ... and the main path's cell at the headline shape, with a nonzero mean shift
    x, labels, std, z = classification_inputs()
    basis = headline_basis(pt, x, z).replace(mean_constant=0.3)
    cost = pt.make_smoothed_bernoulli_cost(labels, std)
    kind, params, aux = general_fused_form(basis, cost)
    require(kind == "bernoulli_sigmoid_smoothed", f"headline cost kind {kind}")
    u0 = pt.PLS(basis, cost).initialise_particles(J, generator=0)
    headline = dict(p=basis.train_projection, u0=u0, y=cost.y_train,
                    eigenvalues=basis.eigenvalues, kind=kind, params=params,
                    mean_shift=basis.mean_constant, aux=aux, eta=STEP_SIZE,
                    patience=math.inf, num_steps=T6, discretisation="preconditioned")
    res["max_abs_err"], _ = hold_zero_noise(
        *b3, f"{kind}/preconditioned N={N} M_k={M} J={J} T={T6}", **headline)

    # (b) stops: a diverging step (non-finite energy), and a patience stop on an
    # energy that rises from the first step (every mode of A unstable, eta sigma >= 3)
    prob = synthetic_general("gaussian")
    hold_stop(*b3, "diverging eta=50", **prob, eta=50.0, patience=math.inf,
                      num_steps=20)
    sigma_min = float(torch.linalg.eigvalsh(drift_system(prob)[0])[0])
    eta = 3.0 / sigma_min
    hold_stop(*b3, f"patience stop eta={eta:.4f} patience=3.5 eta", **prob, eta=eta,
                      patience=3.5 * eta, num_steps=20)

    # (c) determinism: two noisy runs with one seed are bitwise equal (no atomics)
    prob = synthetic_general("bernoulli_sigmoid_smoothed")
    kw = dict(prob, eta=ETA6, patience=math.inf, num_steps=T6, discretisation="preconditioned",
              seed=7)
    u1, e1, _, _ = gen.general_train(**kw)
    u2, e2, _, _ = gen.general_train(**kw)
    require(bool(torch.equal(u1, u2) and torch.equal(e1, e2)), "noisy reruns differ")
    log("  B3 two noisy runs with one seed are bitwise equal")

    # ... and noisy runs against the plain loop on the kernel's own normals
    # (rebuilt from the seed): the three discretisations, rice's M_k, a shard at
    # j0 = 128, and a run that stops; every step a wgmma update
    from benchmark.reference.pls_philox import normals

    seed, steps = 2**33 + 12345, 50
    cases = (("bernoulli_sigmoid_smoothed", N6, M6, J6, disc, None, ETA6, steps)
             for disc in gen.DISCRETISATIONS)
    cases = (*cases, ("student_t", 3048, 55, 1000, "preconditioned", None, ETA6, steps),
             ("gaussian", N6, M6, J6, "exponential", ColumnShard(j0=128, j_total=3 * J6), ETA6,
              steps),
             ("gaussian", N6, M6, J6, "euler", None, 50.0, 20))
    for kind, n, m_k, j, disc, shard, eta, t in cases:
        prob = synthetic_general(kind, n=n, m_k=m_k, j=j, seed=5)
        j0, j_total = (0, j) if shard is None else (shard.j0, shard.j_total)
        eps = normals(seed, m_k, j_total, 0, t, "cuda")[:, :, j0:j0 + j].float()
        what = f"noisy {kind}/{disc} N={n} M_k={m_k} J={j} j0={j0} eta={eta} T={t}"
        steps_before = gen.general_train.steps, gen.general_train.update_wgmma_steps
        u_k, e_k, rec_k, s_k = gen.general_train(**prob, eta=eta, patience=math.inf,
                                                 num_steps=t, discretisation=disc, seed=seed,
                                                 shard=shard)
        u_p, e_p, rec_p, s_p = gen.general_train_reference(
            **prob, eta=eta, patience=math.inf, num_steps=t, discretisation=disc, noise=eps,
            shard=shard)
        torch.cuda.synchronize()
        require(gen.general_train.steps - steps_before[0] == t
                == gen.general_train.update_wgmma_steps - steps_before[1],
                f"{what}: not every step a wgmma update")
        require(int(s_k) == int(s_p) and bool((rec_k == rec_p).all())
                and bool((torch.isnan(e_k) == torch.isnan(e_p)).all()), f"{what}: steps")
        finite = torch.isfinite(u_p)
        require(bool((finite == torch.isfinite(u_k)).all()), f"{what}: non-finite particles")
        scale = max(1.0, float(u_p[finite].abs().max()))
        err_w = float((u_k[finite] - u_p[finite]).abs().max())
        if int(s_p) < t:  # stopped: frozen particles normwise, as hold_stop holds them
            log(f"  B3 {what}: steps_run {int(s_k)} (plain {int(s_p)}), flags and NaN tail "
                f"agree; frozen particles max|dU| {err_w:.3e} of max|U| {scale:.3e}")
            require(err_w <= 1e-4 * scale, f"{what}: frozen particles disagree")
            continue
        err_e = float(((e_k - e_p) / e_p).abs().max())
        log(f"  B3 {what}: max|dU| {err_w:.3e} (max|U| {scale:.2f}), max rel dE {err_e:.3e}")
        require(err_w <= W_TOL * scale and err_e <= E_RTOL, f"{what}: disagrees")

    # (d) the law: Gaussian kind, Euler with noise; in the eigenbasis of A the
    # rows follow N(b_rot / sigma, 2 / (sigma (2 - eta sigma)))
    eta, j_law, t_law = 0.01, 1000, 5000
    prob = synthetic_general("gaussian", m_k=32, j=j_law, seed=4)
    u_t, _, _, _ = gen.general_train(**prob, eta=eta, patience=math.inf, num_steps=t_law,
                                     seed=11)
    a, b = drift_system(prob)
    sigma, q = torch.linalg.eigh(a)
    v = q.T @ u_t.double()
    law_mean, law_var = (q.T @ b) / sigma, 2.0 / (sigma * (2.0 - eta * sigma))
    z_mean = (v.mean(1) - law_mean) / torch.sqrt(law_var / j_law)
    z_var = (v.var(1) - law_var) / (law_var * math.sqrt(2.0 / (j_law - 1)))
    z_max = float(torch.max(z_mean.abs().max(), z_var.abs().max()))
    log(f"  B3 stationary law over 32 rows, J={j_law}, T={t_law}, eta sigma in "
        f"[{eta * float(sigma[0]):.3f}, {eta * float(sigma[-1]):.3f}]: max |z| = {z_max:.2f}")
    require(z_max < 6, "rows do not follow the Euler stationary law")

    # (e) time at the headline: one run of T6 steps with noise
    noisy = dict(headline, seed=1)
    res["ms"] = cuda_ms(lambda: gen.general_train(**noisy), reps=3)
    res["plain_ms"] = cuda_ms(lambda: gen.general_train_reference(**headline), reps=1)
    split = profiled_device_split(lambda: gen.general_train(**noisy), B3_KERNELS, 1)
    dev_ms = sum_measured(split)
    p = basis.train_projection
    dc = torch.randn((N, J), device="cuda")
    matmul_ms = cuda_ms(lambda: (p @ u0, p.T @ dc), reps=20, warmup=2)
    step_ops, products = gen.step_operations(kind, N, M, J), 4 * N * M * J
    nbytes = 4 * (N * M + 2 * M * J + 2 * N + M + T6)
    res["bound_ms"], term = tc_bound(T6 * products, T6 * (step_ops - products), nbytes)
    res["bound_by"] = "bytes" if term == "bytes" else "operations"
    simt_bound_ms = max(1e3 * T6 * step_ops / FP32_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S)
    log(f"  B3 device time {kind}/preconditioned T={T6} (profiler): "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}; per step: "
        f"{split_text(split, T6)}")
    log(f"  B3 time N={N} M_k={M} J={J} T={T6}: kernel {res['ms']:.3f} ms "
        f"({res['ms'] / T6:.4f} ms/step), plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.3f} ms ({term}: 3 TF32 products of {products:.4e} flops at 495 "
        f"TFLOP/s, {step_ops - products:.4e} elementwise ops at 67 TFLOP/s, a step); the fp32 "
        f"SIMT bound of earlier runs {simt_bound_ms:.3f} ms ({step_ops:.4e} ops/step)")
    log(f"  context: the plain version's two fp32 torch.matmul products of one step "
        f"(P U and P^T dc) take {matmul_ms:.4f} ms")
    return res


# --------------------------------------------------------------------------
# phase 7: the slice 2 main path, bench.py's headline classification cell
# --------------------------------------------------------------------------
STEPS7 = 2000
# Accuracy of sign(mean probability) against sign(sin 2x) on N*=4096 test
# points; chance is 0.5 with a spread of 0.008.
# - The bench cell (step 1e-4) is a timing cell: 2000 steps are 0.2 in
#   simulation time, the preconditioned data drift is scaled by the ONB
#   eigenvalues (about 1e-4 to 1e-2 here, printed), and the particles start
#   from N(0, I), so they keep most of their initial noise. The off tier
#   reaches the same accuracy as the kernel there. 0.55 is six spreads above
#   chance: a path that does not train, or drifts the wrong way, fails it.
# - A converging run (step 1e-2: 20 in simulation time, where the
#   preconditioned prior relaxes at rate 1) must classify: the labels
#   disagree with sin(2x) only within noise of its zero crossings, so 0.9.
ACCURACY_MIN_BENCH, ACCURACY_MIN_CONVERGED, STEP_CONVERGED = 0.55, 0.9, 1e-2


def predict_accuracy(pls, trained, x_test):
    """Bernoulli probabilities at x_test (chunked predict, then cost.predict),
    checked to be finite and in [0, 1], and their accuracy against sin(2x) > 0."""
    probs = pls.cost.predict(pls.predict_samples(trained, x_test, generator=0,
                                                 chunk_size=CHUNK)).probs
    require(tuple(probs.shape) == (x_test.shape[0],) and bool(torch.isfinite(probs).all())
            and bool(((probs >= 0) & (probs <= 1)).all()), "probabilities")
    return float(((probs > 0.5) == (torch.sin(2 * x_test[:, 0]) > 0)).float().mean())


def phase_classification(pt, gram, spec, gen):
    x, labels, std, z = classification_inputs()
    x_test = torch.linspace(-3, 3, N_TEST, device="cuda")[:, None]
    for counted in (gram.ard_gram_scaled, spec.spectral_train, gen.general_train):
        counted.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    basis = headline_basis(pt, x, z)
    cost = pt.make_smoothed_bernoulli_cost(labels, std)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m0 = pt.fit_mean_constant_map(basis, cost)
    t2 = time.perf_counter()
    pls = pt.PLS(basis.replace(mean_constant=m0), cost)
    particles = pls.initialise_particles(J, generator=0)
    train = dict(fast_path="general_fused", discretisation="preconditioned")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    trained, energies = pt.train_pls(pls, particles, STEPS7, STEP_SIZE, generator=0, **train)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    accuracy = predict_accuracy(pls, trained, x_test)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    trained_c, energies_c = pt.train_pls(pls, particles, STEPS7, STEP_CONVERGED, generator=0,
                                         **train)
    accuracy_c = predict_accuracy(pls, trained_c, x_test)
    torch.cuda.synchronize()
    launches = {"gram": gram.ard_gram_scaled.launches, "spectral": spec.spectral_train.launches,
                "general": gen.general_train.launches}

    require(launches["general"] == 2, "train_pls did not launch the general kernel")
    require(launches["gram"] >= 2, "the build did not launch the gram kernel")
    require(m0 != 0.0 and math.isfinite(m0), f"MAP mean constant {m0}")
    for e in (energies, energies_c):
        require(len(e) == STEPS7 and all(math.isfinite(v) for v in e), "energies")
        require(e[-1] < e[0], "energy did not fall")
    train_s = t4 - t3
    log(f"  ONB eigenvalues in [{float(basis.eigenvalues.min()):.3e}, "
        f"{float(basis.eigenvalues.max()):.3e}]; build {1e3 * (t1 - t0):.1f} ms; MAP mean "
        f"constant {m0:.5f} in {1e3 * (t2 - t1):.1f} ms")
    log(f"  bench cell: train_pls {STEPS7} steps of {STEP_SIZE} (general_fused, "
        f"preconditioned) {1e3 * train_s:.1f} ms = {1e3 * train_s / STEPS7:.4f} ms/step, "
        f"{STEPS7 / train_s:.1f} updates/s; predict N*={N_TEST} chunk {CHUNK} and "
        f"probabilities {1e3 * (t5 - t4):.1f} ms; energy {energies[0]:.2f} -> "
        f"{energies[-1]:.2f}; accuracy {accuracy:.4f} (threshold {ACCURACY_MIN_BENCH})")
    log(f"  converging run: {STEPS7} steps of {STEP_CONVERGED}: energy {energies_c[0]:.2f} -> "
        f"{energies_c[-1]:.2f}; accuracy {accuracy_c:.4f} (threshold "
        f"{ACCURACY_MIN_CONVERGED}); launches {launches}")
    require(accuracy > ACCURACY_MIN_BENCH, f"bench-cell accuracy {accuracy}")
    require(accuracy_c > ACCURACY_MIN_CONVERGED, f"converged accuracy {accuracy_c}")

    # where train_pls's time goes: B3's device time in a second, profiled run
    b3_ms = profiled_device_ms(
        lambda: pt.train_pls(pls, particles, STEPS7, STEP_SIZE, generator=0, **train),
        B3_KERNELS, 1, warmup=False,
    )
    if b3_ms is None:
        log("  breakdown: B3 device time not measured (the trace shows none)")
    else:
        log(f"  breakdown: MAP fit {1e3 * (t2 - t1):.1f} ms; train_pls {1e3 * train_s:.1f} ms; "
            f"B3 on the device in a profiled rerun {b3_ms:.1f} ms; the difference, host "
            f"remainder plus run-to-run noise, {1e3 * train_s - b3_ms:.1f} ms")

    # bench.py's Euler Bernoulli cell on the same basis (mean constant 0)
    pls_b = pt.PLS(basis, pt.BernoulliCost(y_train=labels))
    before = gen.general_train.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, energies_b = pt.train_pls(pls_b, particles, STEPS7, STEP_SIZE, generator=0,
                                 fast_path="general_fused")
    torch.cuda.synchronize()
    euler_s = time.perf_counter() - t0
    require(gen.general_train.launches > before, "the Euler cell did not launch the kernel")
    require(len(energies_b) == STEPS7 and all(math.isfinite(e) for e in energies_b)
            and energies_b[-1] < energies_b[0], "Euler Bernoulli energies")
    log(f"  bernoulli/euler train_pls {STEPS7} steps {1e3 * euler_s:.1f} ms = "
        f"{1e3 * euler_s / STEPS7:.4f} ms/step, {STEPS7 / euler_s:.1f} updates/s; "
        f"energy {energies_b[0]:.2f} -> {energies_b[-1]:.2f}")
    return launches, (pls, trained_c)


# --------------------------------------------------------------------------
# phase 8: B4, the quadratic trainer
# --------------------------------------------------------------------------
T8 = 1000  # zero-noise comparison steps at the headline width (tolerances: B3's)


def headline_ipb(pt, x, z):
    """bench.py's build(basis_kind="ipb"): the headline kernel on X, Z and
    y(Z) = sin(2Z)."""
    kernel = pt.PLSKernel(
        base_kernel=pt.ARDKernel(
            lengthscales=torch.tensor([0.01], device="cuda"),
            outputscale=torch.tensor(1.0, device="cuda"),
        ),
        approximation_samples=x,
    )
    return pt.build_inducing_point_basis(kernel, z, torch.sin(2 * z[:, 0]), x)


def quadratic_args(basis, cost):
    from projected_langevin_sampling_torch.training import _quadratic_system

    a, b, e_mat, e_bias, e_const, shared = _quadratic_system(basis, cost)
    return (a, b, e_mat, e_bias, None if shared else basis.noise_factor), dict(
        e_const=e_const, shared=shared)


def synthetic_spd(m, gen):
    """Q diag(1 + uniform(0, 1)) Q^T for a random orthogonal Q."""
    q, _ = torch.linalg.qr(torch.randn((m, m), generator=gen, device="cuda"))
    return (q * (1.0 + torch.rand(m, generator=gen, device="cuda"))) @ q.T


def phase_quadratic(pt, quad, tc):
    from projected_langevin_sampling_torch.training import spectral_system_host

    x, y, z = headline_inputs(torch.float32)
    cost = pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, device="cuda"))
    onb, ipb = headline_basis(pt, x, z), headline_ipb(pt, x, z)
    b4 = ("B4", quad.quadratic_train, quad.quadratic_train_reference)
    res = {}
    # (a) zero noise at the headline width, shared (ONB) and non-shared (IPB)
    errs = []
    for name, basis in (("shared (ONB)", onb), ("non-shared (IPB)", ipb)):
        args, kw = quadratic_args(basis, cost)
        u0 = basis.initialise_particles(J, generator=0)
        errs.append(hold_zero_noise(*b4, f"{name} M={M} J={J} T={T8}", *args, u0,
                                    eta=STEP_SIZE, patience=math.inf, num_steps=T8, **kw)[0])
    # ... and at ragged shapes (partial tiles, 4-byte copies where J is not a
    # multiple of 4) on a synthetic system: A and E SPD with eigenvalues in
    # [1, 2], S random; e_const keeps the energies away from 0, where a
    # relative tolerance means nothing
    for m, j in ((100, 37), (513, 1000)):
        gen = torch.Generator(device="cuda").manual_seed(m)
        a_r, e_r = synthetic_spd(m, gen), synthetic_spd(m, gen)
        b_r, eb_r = torch.randn((2, m), generator=gen, device="cuda")
        s_r = torch.randn((m, m), generator=gen, device="cuda") / math.sqrt(m)
        u_r = torch.randn((m, j), generator=gen, device="cuda")
        for shared in (True, False):
            args = (a_r, b_r, a_r, b_r, None) if shared else (a_r, b_r, e_r, eb_r, s_r)
            errs.append(hold_zero_noise(*b4, f"synthetic shared={shared} M={m} J={j} T=200",
                                        *args, u_r, eta=0.05, patience=math.inf, num_steps=200,
                                        e_const=float(m), shared=shared)[0])
    res["max_abs_err"] = max(errs)
    ipb_args, ipb_kw = quadratic_args(ipb, cost)
    spec = spectral_system_host(ipb, cost)
    sigma64 = spec.sigma.double()
    log(f"  IPB drift spectrum (eigenvalues of S^-1 A S) in [{float(sigma64[0]):.2f}, "
        f"{float(sigma64[-1]):.2f}]: eta sigma_max = {STEP_SIZE * float(sigma64[-1]):.3f} at "
        f"eta = {STEP_SIZE} (Euler is stable below 2)")
    require(STEP_SIZE * float(sigma64[-1]) < 2, "the main path's Euler step is unstable")

    # (b) stops: a diverging step, and a patience stop on a synthetic system
    # whose every mode is unstable (eta sigma in [3, 6]), so the energy rises
    # from the first step; shared and non-shared
    u0 = ipb.initialise_particles(J, generator=0)
    hold_stop(*b4, "diverging eta=5 (IPB)", *ipb_args, u0, eta=5.0,
              patience=math.inf, num_steps=30, **ipb_kw)
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, _ = torch.linalg.qr(torch.randn((M, M), generator=gen, device="cuda"))
    a_syn = (q * (1.0 + torch.rand(M, generator=gen, device="cuda"))) @ q.T
    b_syn = torch.randn(M, generator=gen, device="cuda")
    s_syn = torch.randn((M, M), generator=gen, device="cuda") / math.sqrt(M)
    eta = 3.0 / float(torch.linalg.eigvalsh(a_syn)[0])
    for shared, s_mat in ((True, None), (False, s_syn)):
        hold_stop(*b4, f"patience stop eta={eta:.4f} patience=3.5 eta shared={shared}",
                  a_syn, b_syn, a_syn, b_syn, s_mat, u0, eta=eta, patience=3.5 * eta,
                  num_steps=20, e_const=0.0, shared=shared)

    # (c) determinism: two noisy runs with one seed are bitwise equal (no atomics)
    kw = dict(ipb_kw, eta=STEP_SIZE, patience=math.inf, num_steps=200, seed=7)
    u1, e1, _, _ = quad.quadratic_train(*ipb_args, u0, **kw)
    u2, e2, _, _ = quad.quadratic_train(*ipb_args, u0, **kw)
    require(bool(torch.equal(u1, u2) and torch.equal(e1, e2)), "noisy reruns differ")
    log("  B4 two noisy runs with one seed are bitwise equal")

    # (d) the law: in the eigenbasis of S^-1 A S the rows follow
    # N(b_rot / sigma, 2 / (sigma (2 - eta sigma))); eta = 1 / sigma_max
    eta, t_law = 1.0 / float(sigma64[-1]), 2000
    u_t, _, _, _ = quad.quadratic_train(*ipb_args, u0, **dict(ipb_kw, eta=eta, patience=math.inf,
                                                              num_steps=t_law, seed=11))
    v = spec.q_in.double().T @ u_t.double()
    law_mean = spec.b_rot.double() / sigma64
    law_var = 2.0 / (sigma64 * (2.0 - eta * sigma64))
    z_mean = (v.mean(1) - law_mean) / torch.sqrt(law_var / J)
    z_var = (v.var(1) - law_var) / (law_var * math.sqrt(2.0 / (J - 1)))
    z_max = float(torch.max(z_mean.abs().max(), z_var.abs().max()))
    log(f"  B4 stationary law over {M} rows, J={J}, T={t_law}, eta sigma in "
        f"[{eta * float(sigma64[0]):.3f}, 1]: max |z| = {z_max:.2f}")
    require(z_max < 6, "rows do not follow the Euler stationary law")

    # (e) time at the main path's shape: one non-shared run of 20000 steps,
    # one launch whatever T
    kw = dict(ipb_kw, eta=STEP_SIZE, patience=math.inf, num_steps=STEPS)

    def enqueue_ms(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quad.quadratic_train(*ipb_args, u0, seed=1, **dict(kw, num_steps=steps))
        elapsed = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        return elapsed

    run_enqueue_ms, short_enqueue_ms = enqueue_ms(STEPS), min(enqueue_ms(20) for _ in range(3))
    res["ms"] = cuda_ms(lambda: quad.quadratic_train(*ipb_args, u0, seed=1, **kw), reps=2,
                        warmup=0)
    res["plain_ms"] = cuda_ms(lambda: quad.quadratic_train_reference(*ipb_args, u0, **kw), reps=1,
                              warmup=0)
    launches, dev_ms, rec_ms = b4_record(
        quad, lambda: quad.quadratic_train(*ipb_args, u0, seed=1, **kw))
    short_launches, _, _ = b4_record(
        quad, lambda: quad.quadratic_train(*ipb_args, u0, seed=1, **dict(kw, num_steps=20)))
    require(launches == short_launches == 1,
            f"B4 launched {launches} kernels a 20000-step run, {short_launches} a 20-step one")
    onb_args, onb_kw = quadratic_args(onb, cost)
    kw_shared = dict(onb_kw, eta=STEP_SIZE, patience=math.inf, num_steps=STEPS)
    shared_ms = cuda_ms(lambda: quad.quadratic_train(*onb_args, u0, seed=1, **kw_shared), reps=1)
    shared_launches, shared_dev_ms, shared_rec_ms = b4_record(
        quad, lambda: quad.quadratic_train(*onb_args, u0, seed=1, **kw_shared))
    require(shared_launches == 1, f"B4 launched {shared_launches} kernels a shared run")
    a, s_mat, e_mat = ipb_args[0], ipb_args[4], ipb_args[2]
    eps = torch.randn((M, J), device="cuda")
    matmul_ms = cuda_ms(lambda: (a @ u0, s_mat @ eps, e_mat @ u0), reps=20, warmup=2)
    step_ops = quad.step_operations(M, J, shared=False)
    products, elementwise = 3 * 2 * M * M * J, quad.OPS_PER_ELEMENT_STEP * M * J
    nbytes = 4 * (3 * M * M + 2 * M + 2 * M * J + STEPS)
    res["bound_ms"], term = tc_bound(STEPS * products, STEPS * elementwise, nbytes)
    res["bound_by"] = "bytes" if term == "bytes" else "operations"
    simt_bound_ms = max(1e3 * STEPS * step_ops / FP32_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S)
    shared_bound_ms, shared_term = tc_bound(STEPS * products / 3, STEPS * elementwise, nbytes)
    shared_simt_ms = 1e3 * STEPS * quad.step_operations(M, J, shared=True) / FP32_OPS_PER_S
    items, blocks = quad.phase(M, J, shared=False, zero_noise=False), quad.coresident_blocks()
    log(f"  B4 partition: {blocks} blocks fit on the card together, grid "
        f"{tc.persistent_grid(items, blocks)}; a step is {items.items} items ({items.products} "
        f"products x {items.slices} slices x {items.tiles} tiles of 64 x 128)")
    log(f"  B4 launches per run: {launches} at T={STEPS}, {short_launches} at T=20 "
        f"(kernels named {B4_KERNELS}); host enqueue of a run {run_enqueue_ms:.3f} ms at "
        f"T={STEPS}, {short_enqueue_ms:.3f} ms at T=20")
    log(f"  B4 device time non-shared T={STEPS} (the kernel's own record): {dev_ms:.3f} ms "
        f"({1e3 * dev_ms / STEPS:.2f} us/step) of a {rec_ms:.3f} ms call (CUDA events, the "
        f"same run); the call's share outside the kernel (device idle, or the wrapper's small "
        f"kernels) {1 - dev_ms / rec_ms:.4f}")
    log(f"  B4 time M={M} J={J} T={STEPS}: kernel {res['ms']:.3f} ms "
        f"({res['ms'] / STEPS:.5f} ms/step), plain {res['plain_ms']:.1f} ms, bound "
        f"{res['bound_ms']:.3f} ms ({term}: 3 TF32 products of {products:.4e} flops at 495 "
        f"TFLOP/s, {elementwise:.4e} elementwise ops at 67 TFLOP/s, a step); the fp32 SIMT "
        f"bound of earlier runs {simt_bound_ms:.3f} ms ({step_ops:.4e} ops/step)")
    log(f"  B4 shared (ONB) T={STEPS}: kernel {shared_ms:.3f} ms "
        f"({shared_ms / STEPS:.5f} ms/step); device {shared_dev_ms:.3f} ms (its record) of a "
        f"{shared_rec_ms:.3f} ms call (the same run), outside the kernel "
        f"{1 - shared_dev_ms / shared_rec_ms:.4f}; bound {shared_bound_ms:.3f} ms "
        f"({shared_term}), fp32 SIMT bound {shared_simt_ms:.3f} ms")
    log(f"  context: the three fp32 torch.matmul products of one non-shared step take "
        f"{matmul_ms:.4f} ms")
    return res


def b4_record(quad, fn):
    """(B4 kernels started, device ms of the last, call ms) for one call of
    ``fn``: the first two from the kernel's own record on the card (a launch
    count, and its global timer from block 0's start to its end), so that
    neither needs a profiler trace; the call's time from CUDA events around
    the same call."""
    torch.cuda.synchronize()
    runs, _ = quad.record()
    call_ms = cuda_ms(fn, reps=1, warmup=0)
    runs_after, last_ms = quad.record()
    return runs_after - runs, last_ms, call_ms


B4_KERNELS = ("quadratic_run_kernel",)


# --------------------------------------------------------------------------
# phase 9: B5, the fused update
# --------------------------------------------------------------------------
# one step, fp32 both, sums in another order: U normwise; the Poisson
# derivative's 1/f pole amplifies the sum-order differences
U_TOL9 = {"gaussian": 1e-5, "bernoulli_sigmoid": 1e-5, "poisson_square": 1e-4,
          "student_t": 1e-5}


B5_KERNELS = ("dc_kernel", "update_kernel")


def phase_fused(pt, fused):
    from projected_langevin_sampling_torch.closed_forms import dc_kind_for_cost

    x, y, z = headline_inputs(torch.float32)
    onb, ipb = headline_basis(pt, x, z), headline_ipb(pt, x, z)
    rng = np.random.default_rng(9)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    f_true = torch.sin(2 * x[:, 0])
    costs = {
        "gaussian": pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, device="cuda")),
        "bernoulli_sigmoid": pt.BernoulliCost(y_train=(y > 0).float()),
        "poisson_square": pt.PoissonCost(
            y_train=as_t(rng.poisson(((2.0 + f_true) ** 2).cpu().numpy()))),
        "student_t": pt.StudentTCost(y_train=y, degrees_of_freedom=4.0, scale=0.3),
    }
    res, errs, timed = {}, [], None
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = torch.randn((M, J), generator=gen, device="cuda")
    for bname, basis in (("ONB diagonal prior", onb), ("IPB matrix prior", ipb)):
        if basis is onb:
            d, prior = basis.train_projection, 1.0 / basis.eigenvalues
        else:
            d, prior = basis.base_gram_induce_train.T, M * basis.inv_base_gram_induce
        u = basis.initialise_particles(J, generator=1)
        for kind, cost in costs.items():
            got_kind, params = dc_kind_for_cost(cost)
            require(got_kind == kind, f"dc kind {got_kind} for {kind}")
            # Poisson: F away from the 1/f pole, as phase 6 trains it: a mean
            # shift of 3 and particles 0.2 u. (Next to the pole, where P (u + 2)
            # + 0.3 comes at this shape, any two fp32 products that sum in
            # different orders differ by the order of max|U|.)
            uu, shift = (0.2 * u, 3.0) if kind == "poisson_square" else (u, 0.3)
            args = (basis.train_projection, d, cost.y_train, uu, prior, noise, kind)
            kw = dict(eta=STEP_SIZE, params=params, mean_shift=shift)
            if kind == "poisson_square":
                f_min = float((basis.train_projection @ uu + shift).abs().min())
                require(f_min >= 1.0, f"Poisson case within {f_min} of the pole")
            got = fused.fused_update(*args, **kw)
            plain = fused.fused_update_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            scale = float(plain.abs().max())
            log(f"  B5 {bname:<18s} {kind:<17s} max|dU| {err:.3e} (max|U| {scale:.2f})")
            require(err <= U_TOL9[kind] * scale, f"fused update disagrees: {bname} {kind}")
            errs.append(err)
            if basis is ipb and kind == "bernoulli_sigmoid":  # phase 10's langevin_steps cell
                timed = (args, kw, got)
    res["max_abs_err"] = max(errs)
    args, kw, got = timed
    res["fused_call"] = timed  # phase 12 (b) holds the fused mode to this output
    res["ms"] = cuda_ms(lambda: fused.fused_update(*args, **kw), reps=20, warmup=2)
    res["plain_ms"] = cuda_ms(lambda: fused.fused_update_reference(*args, **kw), reps=10, warmup=1)
    split = profiled_device_split(lambda: fused.fused_update(*args, **kw), B5_KERNELS, 10)
    dev_ms = sum_measured(split)

    def host_ms(calls=20):
        # the host's own time per call, its launches queued behind a device sleep
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fused.fused_update(*args, **kw)
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e3 * elapsed / calls

    host_call_ms = min(host_ms() for _ in range(3))
    p, u = args[0], args[3]
    dc = torch.randn((N, J), device="cuda")
    matmul_ms = cuda_ms(lambda: (p @ u, ipb.base_gram_induce_train @ dc), reps=20, warmup=2)
    ops = fused.step_operations("bernoulli_sigmoid", N, M, J, prior_is_diag=False)
    products = 4 * N * M * J + 2 * M * M * J
    nbytes = 4 * (2 * N * M + N + M * M + 3 * M * J)
    res["bound_ms"], term = tc_bound(products, ops - products, nbytes)
    res["bound_by"] = "bytes" if term == "bytes" else "operations"
    simt_bound_ms = max(1e3 * ops / FP32_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S)
    log(f"  B5 device time IPB bernoulli_sigmoid (profiler): "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} ({split_text(split)}); "
        f"the host's own time per call {host_call_ms:.4f} ms")
    log(f"  B5 time N={N} M={M} J={J}, IPB bernoulli_sigmoid: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({term}: 3 TF32 products of "
        f"{products:.4e} flops at 495 TFLOP/s, {ops - products:.4e} elementwise ops at 67 "
        f"TFLOP/s); the fp32 SIMT bound of earlier runs {simt_bound_ms:.4f} ms ({ops:.4e} ops)")
    log(f"  context: the two fp32 torch.matmul products of one step (P U and k(Z,X) dc) take "
        f"{matmul_ms:.4f} ms")
    return res


# --------------------------------------------------------------------------
# phase 9b: Q1, the smoothed-Bernoulli quadrature of the off tier (port only)
# --------------------------------------------------------------------------
# the rice main's training rows at J = 1000 with the GH16 rule, as
# rice_classification_j1000.train runs it
N9B, J9B, Q9B = 3048, 1000, 16
# dc within 1e-13 and cost within 1e-12 of the plain version, relative to
# their largest magnitudes, in fp64; 1e-5 in fp32
TOL9B = {torch.float64: (1e-13, 1e-12), torch.float32: (1e-5, 1e-5)}
# the H100 SXM's boost clock, and the fp64 pipe's rate: 64 lanes a clock an
# SM, so a warp's fp64 instruction holds a scheduler's pipe two clocks
SM_CLOCK_HZ, FP64_CLOCKS_A_WARP_OP = 1.98e9, 2
FP64_OPCODES = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")
Q1_KERNELS = ("quadrature_kernel", "column_sum_kernel")
Q1_UNROLL = 4  # the node loop's #pragma unroll (csrc/smoothed_bernoulli.cu)


def q1_node_mix(lib_path):
    """SASS instructions a node of the fp64 quadrature kernel, from its
    largest innermost loop (the node loop, unrolled Q1_UNROLL times): all of
    them, the fp64 pipe's, MUFU and calls; and every innermost loop's
    length. (None, []) without cuobjdump or where no loop is found."""
    text = sass_text(lib_path)
    if text is None:
        return None, []
    entries = next((e for name, e in sass_functions(text).items()
                    if "quadrature_kernel" in name and "IdE" in name), None)
    loops = innermost_loops(entries or [])
    if not loops:
        return None, []
    a, b = max(loops, key=lambda ab: ab[1] - ab[0])
    ops = [e[1].split(".")[0] for e in entries[a:b + 1]]
    return {"total": len(ops) / Q1_UNROLL,
            "fp64": sum(op in FP64_OPCODES for op in ops) / Q1_UNROLL,
            "mufu": ops.count("MUFU") / Q1_UNROLL, "calls": ops.count("CALL") / Q1_UNROLL}, \
        sorted(d - c + 1 for c, d in loops)


def smoothed_inputs(dtype, seed=11):
    """F (N9B, J9B) of |F| about 3, labels, stds in [0, 0.9] and the GH16
    rule on the card, in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    f = 3.0 * torch.randn((N9B, J9B), generator=g, dtype=torch.float64)
    y = (torch.rand(N9B, generator=g, dtype=torch.float64) > 0.5).to(torch.float64)
    s = 0.9 * torch.rand(N9B, generator=g, dtype=torch.float64)
    nodes, weights = np.polynomial.hermite.hermgauss(Q9B)
    as_t = lambda a: torch.as_tensor(a).to(device="cuda", dtype=dtype)  # noqa: E731
    return as_t(f), [as_t(y), as_t(s), as_t(nodes), as_t(weights)]


def phase_smoothed(sbk, build):
    """Q1 against its plain version at the rice main's shape, fp64 and fp32:
    the gaps, a bitwise rerun, the device split, the call's ms between
    events, the host's enqueue, the plain version's ms and kernel count; the
    bound from the bytes and the node loop's SASS."""
    res = {}
    mix, loops = q1_node_mix(build.library_path("smoothed_bernoulli"))
    log("  Q1 fp64 node loop (SASS a node): " + ("not measured (no cuobjdump or no loop)"
                                                if mix is None else mix_text(mix))
        + f"; the kernel's innermost loops, instructions: {loops}")
    for dtype in (torch.float64, torch.float32):
        f, rule = smoothed_inputs(dtype)
        kernel = lambda: sbk.smoothed_bernoulli(f, *rule)  # noqa: E731
        plain = lambda: sbk.smoothed_bernoulli_reference(f, *rule)  # noqa: E731
        got_cost, got_dc = kernel()
        want_cost, want_dc = plain()
        dc_gap = float((got_dc - want_dc).abs().max() / want_dc.abs().max())
        cost_gap = float((got_cost - want_cost).abs().max() / want_cost.abs().max())
        tol = TOL9B[dtype]
        require(dc_gap <= tol[0] and cost_gap <= tol[1],
                f"Q1 {dtype}: dc gap {dc_gap:.3e}, cost gap {cost_gap:.3e} (limits {tol})")
        again = kernel()
        require(torch.equal(again[0], got_cost) and torch.equal(again[1], got_dc),
                f"Q1 {dtype}: a rerun differs")
        split = profiled_device_split(kernel, Q1_KERNELS, 50)
        call_ms = cuda_ms(kernel, reps=50, warmup=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            kernel()
        enqueue_us = 1e6 * (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, reps=5)
        plain_kernels = profiled_kernel_count(plain)
        bytes_ms = 1e3 * 2 * N9B * J9B * f.element_size() / HBM_BYTES_PER_S  # F read, dc written
        log(f"  Q1 {str(dtype)[6:]} {N9B} x {J9B}, Q = {Q9B}: dc gap {dc_gap:.3e}, cost gap "
            f"{cost_gap:.3e} (limits {tol[0]:g}, {tol[1]:g}); rerun bitwise equal; device "
            f"{split_text(split)}; call {call_ms:.4f} ms; host enqueue {enqueue_us:.1f} us a "
            f"call; plain {plain_ms:.4f} ms ({plain_kernels} kernels a call); bytes bound "
            f"{bytes_ms:.4f} ms")
        if dtype == torch.float64:
            res.update(max_abs_err=float((got_dc - want_dc).abs().max()), ms=call_ms,
                       plain_ms=plain_ms, device_ms=sum_measured(split))
            warps = N9B * J9B / 32
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            bounds = {"bytes": bytes_ms}
            if mix is not None:  # one warp instruction a clock a scheduler, 4 an SM
                per_clock = 4 * sms * SM_CLOCK_HZ
                bounds["issue"] = 1e3 * warps * Q9B * mix["total"] / per_clock
                bounds["fp64 pipe"] = (1e3 * warps * Q9B * mix["fp64"] * FP64_CLOCKS_A_WARP_OP
                                       / per_clock)
            res["bound_by"] = max(bounds, key=bounds.get)
            res["bound_ms"] = bounds[res["bound_by"]]
            device = res["device_ms"]
            log("  Q1 fp64 bound: " + ", ".join(f"{k} {v:.4f} ms" for k, v in bounds.items())
                + f" ({sms} SMs at {SM_CLOCK_HZ / 1e9:.2f} GHz); the kernel runs at "
                + ("a share not measured" if device is None
                   else f"{100 * res['bound_ms'] / device:.1f}%") + " of its bound")
    return res


# --------------------------------------------------------------------------
# phase 10: the slice 3 main path, bench.py's IPB cells
# --------------------------------------------------------------------------
STEPS10 = 2000
# Thresholds:
# - RMSE of the predictive mean against sin(2x) on N*=4096 test points. Both
#   Gaussian tiers share one law; the first full run gave 0.3890 and 0.3892
#   (phase 4's ONB tier 0.3892). 0.45 leaves room for the spread of a mean
#   over 1000 particles and fails any run that has not trained (a zero mean
#   gives 0.71).
# - Accuracy of the Bernoulli runs, as phase 7's: chance is 0.5 with a spread
#   of 0.008, and 0.55 is six spreads above it. The first full run gave
#   0.9922 for both: at 1e-4 the Euler chain on the W-space prior relaxes at
#   rates 1/lambda_hat of 240-4300, so 0.2 in simulation time reaches the
#   posterior; the threshold stays at phase 7's, which any trained run clears.
RMSE_MAX, ACCURACY_MIN10 = 0.45, 0.55


def run_counted(counters, fn):
    """``fn()`` with every launch counter set to 0 just before it; returns
    (result, seconds, launches by name)."""
    for counted in counters.values():
        counted.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: c.launches for k, c in counters.items()}


def phase_ipb_path(pt, counters):
    x, y, z = headline_inputs(torch.float32)
    x_test = torch.linspace(-3, 3, N_TEST, device="cuda")[:, None]
    truth = torch.sin(2 * x_test[:, 0])
    launches = {}
    ipb, build_s, launches["build"] = run_counted(counters, lambda: headline_ipb(pt, x, z))
    require(launches["build"]["gram"] >= 2, "the build did not launch the gram kernel")
    cost = pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, device="cuda"))
    pls = pt.PLS(ipb, cost)
    particles = pls.initialise_particles(J, generator=0)
    log(f"  build_inducing_point_basis {1e3 * build_s:.1f} ms; launches {launches['build']}")
    rmses = {}
    for fast_path, kernel in (("quadratic_fused", "quadratic"), ("auto", "spectral")):
        (trained, energies), train_s, counts = run_counted(
            counters, lambda: pt.train_pls(pls, particles, STEPS, STEP_SIZE, generator=0,
                                           fast_path=fast_path))
        require(counts[kernel] == 1, f"train_pls({fast_path}) launched {kernel} {counts[kernel]} "
                                     "times, not once")
        require(len(energies) == STEPS and all(math.isfinite(e) for e in energies), "energies")
        require(energies[-1] < energies[0], "energy did not fall")
        samples, predict_s, _ = run_counted(
            counters, lambda: pls.predict_samples(trained, x_test, generator=0, chunk_size=CHUNK))
        require(tuple(samples.shape) == (N_TEST, J) and bool(torch.isfinite(samples).all()),
                "predicted samples")
        rmses[fast_path] = float(torch.sqrt(torch.mean((samples.mean(1) - truth) ** 2)))
        launches[fast_path] = counts
        log(f"  train_pls({fast_path}) {STEPS} steps {1e3 * train_s:.1f} ms = "
            f"{1e3 * train_s / STEPS:.5f} ms/step, {STEPS / train_s:.1f} updates/s; energy "
            f"{energies[0]:.2f} -> {energies[-1]:.2f}; predict N*={N_TEST} chunk {CHUNK} "
            f"{1e3 * predict_s:.1f} ms; predictive-mean RMSE vs sin(2x) "
            f"{rmses[fast_path]:.4f} (threshold {RMSE_MAX}); launches {counts}")
    require(all(r < RMSE_MAX for r in rmses.values()), f"RMSE {rmses}")

    # bench.py's IPB Bernoulli cell, through the W-space view (B3), then the
    # throughput path on the same model (B5 per step)
    _, labels, _, _ = classification_inputs()  # bench.py's labels on the same X
    pls_b = pt.PLS(ipb, pt.BernoulliCost(y_train=labels))
    (trained_b, energies_b), train_s, counts = run_counted(
        counters, lambda: pt.train_pls(pls_b, particles, STEPS10, STEP_SIZE, generator=0,
                                       fast_path="general_fused"))
    require(counts["general"] == 1, "the W-space view did not launch the general kernel")
    require(len(energies_b) == STEPS10 and all(math.isfinite(e) for e in energies_b)
            and energies_b[-1] < energies_b[0], "IPB Bernoulli energies")
    accuracy = predict_accuracy(pls_b, trained_b, x_test)
    launches["general_fused"] = counts
    log(f"  IPB bernoulli train_pls(general_fused) {STEPS10} steps {1e3 * train_s:.1f} ms = "
        f"{1e3 * train_s / STEPS10:.4f} ms/step, {STEPS10 / train_s:.1f} updates/s; energy "
        f"{energies_b[0]:.2f} -> {energies_b[-1]:.2f}; accuracy {accuracy:.4f} "
        f"(threshold {ACCURACY_MIN10}); launches {counts}")
    stepped, steps_s, counts = run_counted(
        counters, lambda: pt.langevin_steps(ipb, pls_b.cost, particles, 0, STEP_SIZE, STEPS10,
                                            fast_path="off"))
    require(counts["fused"] == STEPS10, f"langevin_steps launched B5 {counts['fused']} times")
    require(bool(torch.isfinite(stepped).all()), "langevin_steps particles")
    accuracy_s = predict_accuracy(pls_b, stepped, x_test)
    launches["langevin_steps"] = counts
    log(f"  IPB bernoulli langevin_steps(off) {STEPS10} steps {1e3 * steps_s:.1f} ms = "
        f"{1e3 * steps_s / STEPS10:.4f} ms/step, {STEPS10 / steps_s:.1f} updates/s; accuracy "
        f"{accuracy_s:.4f} (threshold {ACCURACY_MIN10}); launches {counts}")
    require(accuracy > ACCURACY_MIN10 and accuracy_s > ACCURACY_MIN10,
            f"IPB Bernoulli accuracy {accuracy}, {accuracy_s}")
    return launches


# --------------------------------------------------------------------------
# phase 11: the slice 4 main path, the UCI regression protocol
# --------------------------------------------------------------------------
# kin8nm's shape, the largest UCI regression set of the repo: N = 8192 rows,
# D = 8, fp64, split 80/10/10 (experiments/uci/regression/config.yaml)
N11, D11, J11 = 8192, 8, 100
SUBSAMPLE11, LR11, BATCH11 = 5000, 1e-2, 5000  # config.yaml's kernel and svgp settings
GP_EPOCHS11, SVGP_EPOCHS11, SVGP_LR11 = 100, 20, 0.1
PLS_DURATION11, PLS_STEP_MAX11 = 0.5, 1e-3  # config.yaml's simulation time and step cap
COVERAGE11 = 0.95
# B2's backward against plain autograd, normwise: max|dL/dp kernel - plain|
# over max|dL/dp plain| for each parameter p. Both are the same algebra in
# another order of summation; on the CPU at these shapes (where the forward
# is the plain version) they differ by at most 3e-15 in fp64 and 5e-7 in fp32,
# and the fp32 plain autograd itself errs by up to 1.3e-6 against fp64. On
# the card the kernel's gram also differs from the plain one within phase
# 2's rtol (1e-5 in fp32), which moves W = G K by as much: 1e-10 and 1e-4.
B2_GRAD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def kin8nm_like(seed=0):
    """experiments/uci/make_synthetic_datasets.py:30-55 at kin8nm's shape:
    correlated Gaussian inputs, targets a sum of 8 RBF bumps plus noise at
    0.1 of their spread; split 80/10/10 and normalised on the training split,
    as the experiments do."""
    rng = np.random.default_rng(seed)
    mixing = rng.normal(size=(D11, D11)) / np.sqrt(D11)
    x = rng.normal(size=(N11, D11)) @ mixing
    centres = rng.normal(size=(8, D11))
    weights = rng.normal(size=8) * 2.0
    d2 = ((x[:, None, :] - centres[None, :, :]) / np.sqrt(D11)) ** 2
    f = np.exp(-0.5 * d2.sum(-1)) @ weights
    y = f + 0.1 * np.std(f) * rng.normal(size=N11)
    perm = rng.permutation(N11)
    n_train, n_val = round(0.8 * N11), round(0.1 * N11)
    parts = np.split(perm, [n_train, n_train + n_val])
    x_mean, x_std = x[parts[0]].mean(0), x[parts[0]].std(0)
    y_mean, y_std = y[parts[0]].mean(), y[parts[0]].std()
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    return [(as_t((x[p] - x_mean) / x_std), as_t((y[p] - y_mean) / y_std)) for p in parts]


def b2_backward_check(pt, gram, x_sub, z, x_train):
    """(a): B2's gradient on the card against the plain version's autograd,
    for the lengthscales, the outputscale and both inputs; returns the
    backward's time beside the plain autograd's at each shape."""
    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram, ard_gram_scaled_reference

    times = {}
    for dtype in (torch.float64, torch.float32):
        for kind, a, b in (("same", x_sub, None), ("cross", z, x_train)):
            name = f"{kind} {a.shape[0]}x{(a if b is None else b).shape[0]}"
            gen = torch.Generator(device="cuda").manual_seed(2)
            ls = torch.linspace(0.8, 2.0, D11, dtype=dtype, device="cuda")
            n2 = a.shape[0] if b is None else b.shape[0]
            g = torch.randn((a.shape[0], n2), generator=gen, dtype=dtype, device="cuda")

            def leaves():
                x1 = a.to(dtype).clone().requires_grad_(True)
                x2 = None if b is None else b.to(dtype).clone().requires_grad_(True)
                params = [x1, ls.clone().requires_grad_(True),
                          torch.tensor(1.3, dtype=dtype, device="cuda", requires_grad=True)]
                return params + ([] if x2 is None else [x2])

            def kernel_loss(p):
                k = pt.ARDKernel(p[1], p[2])(p[0], p[3] if len(p) > 3 else None)
                return torch.sum(g * k), k

            def plain_loss(p):
                s1 = p[0] / p[1]
                s2 = s1 if len(p) == 3 else p[3] / p[1]
                return torch.sum(g * ard_gram_scaled_reference(s1, s2, p[2], same=len(p) == 3)), None

            pk, pp = leaves(), leaves()
            (loss_k, k), (loss_p, _) = kernel_loss(pk), plain_loss(pp)
            require(type(k.grad_fn) is ARDGram._backward_cls,
                    f"the card's gram carries {type(k.grad_fn).__name__}, not ARDGram's backward")
            grads_k = torch.autograd.grad(loss_k, pk, retain_graph=True)
            grads_p = torch.autograd.grad(loss_p, pp, retain_graph=True)
            errs = [float((gk - gp).abs().max() / gp.abs().max()) for gk, gp in zip(grads_k, grads_p)]
            tol = B2_GRAD_TOL[dtype]
            log(f"  (a) B2 backward {dtype} {name}: normwise error against plain autograd for "
                f"x1, lengthscales, outputscale{', x2' if len(pk) > 3 else ''}: "
                + ", ".join(f"{e:.2e}" for e in errs) + f" (tolerance {tol:.0e})")
            require(all(e <= tol for e in errs), f"B2 backward disagrees: {dtype} {name} {errs}")
            backward_ms = cuda_ms(lambda: torch.autograd.grad(loss_k, pk, retain_graph=True), 5)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(loss_p, pp, retain_graph=True), 5)
            times[(dtype, kind)] = (backward_ms, plain_ms)
            log(f"      backward {backward_ms:.3f} ms (plain autograd's {plain_ms:.3f} ms)")
    return times


def b2_backward_keys(launches_11, backward_harness):
    """B2's backward on the slice 4 and 6-9 paths: the passes the fits ran
    (phases 11 and 13-16), and the time of one backward at the exact GP's gram
    (5000 x 5000 same-input, fp64) beside the plain version's autograd."""
    backward_ms, plain_ms = launches_11["backward_ms"][(torch.float64, "same")]
    return {"backward_launches": launches_11["backward"] + backward_harness,
            "backward_ms": backward_ms,
            "backward_plain_ms": plain_ms}


def exact_gp_breakdown(exact, x_sub, y_sub):
    """Where an epoch of the exact GP's fit goes, each part timed alone with
    CUDA events at the fitted parameters: the same-input gram (B2), the
    factorisation of K + noise I (nan_rescued_cholesky: one probe and the
    factor; a plain torch.linalg.cholesky beside it), the loss forward, and
    forward plus backward."""
    from projected_langevin_sampling_torch.models.gaussian_process.training import (
        _exact_gp_from_params,
    )
    from projected_langevin_sampling_torch.ops.linalg import nan_rescued_cholesky

    params = {
        "mean_constant": exact.mean_constant, "log_lengthscales": torch.log(exact.kernel.lengthscales),
        "log_outputscale": torch.log(exact.kernel.outputscale), "log_noise": torch.log(exact.noise),
    }
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = lambda: -_exact_gp_from_params(params, x_sub, y_sub).log_marginal_likelihood()  # noqa: E731
    k_noisy = exact.kernel(x_sub) + exact.noise * torch.eye(x_sub.shape[0], dtype=x_sub.dtype,
                                                              device=x_sub.device)
    return {
        "gram": cuda_ms(lambda: exact.kernel(x_sub), 10),
        "nan_rescued_cholesky": cuda_ms(lambda: nan_rescued_cholesky(k_noisy), 5),
        "plain cholesky": cuda_ms(lambda: torch.linalg.cholesky(k_noisy), 5),
        "loss forward": cuda_ms(loss, 5),
        "forward + backward": cuda_ms(
            lambda: torch.autograd.grad(loss(), list(params.values())), 5),
    }


def phase_slice4(pt, gram, counters, classifier):
    from projected_langevin_sampling_torch.models.gaussian_process.likelihoods import (
        GaussianLikelihood,
    )
    from projected_langevin_sampling_torch.models.temper.pls_classification import _bernoulli_nll
    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram
    from projected_langevin_sampling_torch.training import spectral_system_host
    import scipy.stats

    (x_train, y_train), (x_val, y_val), (x_test, y_test) = kin8nm_like()
    n_train = x_train.shape[0]
    m = round(math.sqrt(n_train))
    log(f"  data: N={N11} D={D11} fp64, train/validation/test {n_train}/{x_val.shape[0]}/"
        f"{x_test.shape[0]}; M = round(sqrt(N_train)) = {m}; J = {J11}")
    ard0 = pt.ARDKernel(torch.ones(D11, dtype=torch.float64, device="cuda"),
                        torch.tensor(1.0, dtype=torch.float64, device="cuda"))
    x_sub, sub_idx = pt.RandomInducingPointSelector()(x_train, SUBSAMPLE11, ard0,
                                                      rng=np.random.default_rng(0))
    y_sub = y_train[sub_idx]

    # (b) the exact GP on the subsample
    ARDGram.backward_calls = 0
    (exact, gp_losses), gp_s, gp_launches = run_counted(counters, lambda: pt.fit_exact_gp(
        x_sub, y_sub, ard0, learning_rate=LR11, number_of_epochs=GP_EPOCHS11))
    gp_backward = ARDGram.backward_calls
    require(len(gp_losses) == GP_EPOCHS11 and all(math.isfinite(v) for v in gp_losses),
            "exact GP losses")
    require(gp_losses[-1] < gp_losses[0], "the exact GP's MLL did not rise")
    require(gp_launches["gram"] >= GP_EPOCHS11 and gp_backward >= GP_EPOCHS11,
            f"the exact GP fit ran B2 {gp_launches['gram']} times, its backward {gp_backward}")
    log(f"  (b) fit_exact_gp N={SUBSAMPLE11}, {GP_EPOCHS11} epochs at {LR11}: "
        f"{1e3 * gp_s / GP_EPOCHS11:.1f} ms/epoch; -MLL/N {gp_losses[0]:.5f} -> "
        f"{gp_losses[-1]:.5f}; B2 launches {gp_launches['gram']}, backward passes {gp_backward}; "
        f"lengthscales {[round(v, 3) for v in exact.kernel.lengthscales.tolist()]}, "
        f"outputscale {float(exact.kernel.outputscale):.4f}, noise {float(exact.noise):.5f}")

    # (c) the SVGP on the learned kernel, M inducing points, batch 5000
    z, _ = pt.ConditionalVarianceInducingPointSelector()(x_train, m, exact.kernel,
                                                         rng=np.random.default_rng(0))
    split = exact_gp_breakdown(exact, x_sub, y_sub)
    log(f"  (b) one epoch's parts at {x_sub.shape[0]} rows, fp64 (CUDA events, alone): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()))
    backward_times = b2_backward_check(pt, gram, x_sub, z, x_train)
    kernel = pt.PLSKernel(base_kernel=exact.kernel, approximation_samples=z)
    likelihood = GaussianLikelihood(noise=exact.noise)
    svgp0 = pt.init_svgp(float(exact.mean_constant), kernel, likelihood, z)
    ARDGram.backward_calls = 0
    (svgp, svgp_losses), svgp_s, svgp_launches = run_counted(counters, lambda: pt.fit_svgp(
        svgp0, x_train, y_train, SVGP_EPOCHS11, BATCH11, SVGP_LR11,
        learn_inducing_locations=True, generator=0))
    svgp_backward = ARDGram.backward_calls
    require(svgp is not None and len(svgp_losses) == SVGP_EPOCHS11, "SVGP fit")
    require(svgp_losses[-1] < svgp_losses[0], "the SVGP's ELBO did not rise")
    require(svgp_launches["gram"] > 0 and svgp_backward > 0, "the SVGP fit did not run B2")
    titsias = pt.titsias_optimal_svgp(svgp, x_train, y_train)
    elbo_fit = float(svgp.elbo(x_train, y_train, n_train)) / n_train
    elbo_opt = float(titsias.elbo(x_train, y_train, n_train)) / n_train
    require(math.isfinite(elbo_opt) and elbo_opt >= elbo_fit - 1e-9,
            f"Titsias's q(u) has ELBO/N {elbo_opt}, below the fit's {elbo_fit}")
    log(f"  (c) fit_svgp M={m}, batch {BATCH11}, {SVGP_EPOCHS11} epochs at {SVGP_LR11}, "
        f"inducing inputs learned: {1e3 * svgp_s / SVGP_EPOCHS11:.1f} ms/epoch; -ELBO/N "
        f"{svgp_losses[0]:.5f} -> {svgp_losses[-1]:.5f}; B2 launches {svgp_launches['gram']}, "
        f"backward passes {svgp_backward}; ELBO/N of Titsias's optimum {elbo_opt:.5f} >= "
        f"the fit's {elbo_fit:.5f}")

    # (d) the ONB Gaussian PLS with Student-T extra predictive noise, on B1
    residuals = (y_train - exact.predict_y(x_train).mean).cpu().numpy()
    df, _, t_scale = scipy.stats.t.fit(residuals, floc=0)
    df = min(float(df), 1e6)  # experiments/uci/regression/main.py:125-138
    # the likelihood's noise variance as the t's scale, as the reference does
    noise = pt.StudentTPredictiveNoise(df=df, loc=0.0, scale=float(exact.noise))
    pls_kernel = pt.PLSKernel(base_kernel=exact.kernel, approximation_samples=z)
    (basis, build_s, build_launches) = run_counted(counters, lambda: pt.build_orthonormal_basis(
        pls_kernel, z, x_train, additional_predictive_noise_distribution=noise, verbose=False))
    cost = pt.GaussianCost(y_train=y_train, observation_noise=exact.noise)
    pls = pt.PLS(basis, cost)
    sigma_max = float(spectral_system_host(basis, cost).sigma.max())
    step = min(PLS_STEP_MAX11, 1.0 / sigma_max)  # half the Euler bound 2 / sigma_max
    steps = min(math.ceil(PLS_DURATION11 / step), 20_000)
    particles = pls.initialise_particles(J11, generator=0)
    (trained, energies), train_s, train_launches = run_counted(
        counters, lambda: pt.train_pls(pls, particles, steps, step, generator=0))
    require(train_launches["spectral"] == 1, f"train_pls launched B1 {train_launches['spectral']} times")
    require(len(energies) == steps and all(math.isfinite(e) for e in energies)
            and energies[-1] < energies[0], "PLS energies")
    log(f"  (d) Student-T noise df {df:.4g} (t fit scale {t_scale:.4f}), scale {float(exact.noise):.5f}; "
        f"ONB M_k={basis.approximation_dimension} built in {1e3 * build_s:.1f} ms; sigma_max "
        f"{sigma_max:.4g}, step {step:.3g}, {steps} steps: train_pls(auto) {1e3 * train_s:.1f} ms; "
        f"energy {energies[0]:.2f} -> {energies[-1]:.2f}; launches {train_launches}")

    # (e) calibration on the validation split, coverage on the test split.
    # Split conformal intervals cover at least 0.95 and at most 0.95 +
    # 1/(n_cal + 1) on average; the coverage of n = 819 test points has a
    # binomial sd sqrt(0.95 0.05 / n) = 0.0076, and the calibration split's
    # draw adds about the same (a beta law of the same size), so 4 of the
    # combined sd (0.043) about that range fails a run whose intervals are
    # wrong while passing every correct one but 1 in 15,000.
    n_val, n_test = x_val.shape[0], x_test.shape[0]
    spread = math.sqrt(COVERAGE11 * (1 - COVERAGE11) * (1 / n_test + 1 / (n_val + 2)))
    band = (COVERAGE11 - 4 * spread, COVERAGE11 + 1 / (n_val + 1) + 4 * spread)
    t0 = time.perf_counter()
    models = {
        "TemperPLS": pt.TemperPLS(x_val, y_val, pls, trained, generator=1),
        "TemperGP": pt.TemperGP(svgp, x_val, y_val),
    }
    for name, model in models.items():
        pred = model(x_test)
        nll = float(pred.negative_log_likelihood(y_test))
        require(math.isfinite(model.scale) and model.scale > 0 and math.isfinite(nll),
                f"{name} scale {model.scale}, NLL {nll}")
        log(f"  (e) {name}: scale {model.scale:.4f}, test NLL {nll:.4f}")
    for name, model in {
        "ConformalisePLS": pt.ConformalisePLS(x_val, y_val, pls, trained, generator=2),
        "ConformaliseGP": pt.ConformaliseGP(svgp, x_val, y_val),
    }.items():
        pred = model(x_test, COVERAGE11)
        coverage = float(((pred.lower <= y_test) & (y_test <= pred.upper)).double().mean())
        width = float((pred.upper - pred.lower).mean())
        log(f"  (e) {name}: test coverage of the {COVERAGE11} intervals {coverage:.4f} (band "
            f"[{band[0]:.4f}, {band[1]:.4f}]), mean width {width:.4f}")
        require(band[0] <= coverage <= band[1], f"{name} coverage {coverage} outside {band}")
    calib_s = time.perf_counter() - t0

    # (f) Dirichlet targets and a fixed-noise exact GP on phase 7's
    # classification data; spread tempering of phase 7's trained model
    x7, labels7, _, _ = classification_inputs()
    x7, labels7 = x7.double(), labels7.double()
    targets, noise_var, classes = pt.dirichlet_classification_targets(labels7.long())
    require(classes == 2, f"{classes} classes")
    ard7 = pt.ARDKernel(torch.ones(1, dtype=torch.float64, device="cuda"),
                        torch.tensor(1.0, dtype=torch.float64, device="cuda"))
    (gp7, losses7), gp7_s, gp7_launches = run_counted(counters, lambda: pt.fit_exact_gp(
        x7, targets[1].double(), ard7, learning_rate=0.1, number_of_epochs=GP_EPOCHS11,
        fixed_noise_variances=noise_var[1].double()))
    require(losses7[-1] < losses7[0] and gp7_launches["gram"] >= GP_EPOCHS11,
            "the Dirichlet fit did not learn through B2")
    pls7, trained7 = classifier
    gen = np.random.default_rng(11)
    x_cal = np.sort(gen.uniform(-3, 3, (1000, 1)), axis=0)
    y_cal = (np.sin(2 * x_cal[:, 0]) + 0.2 * gen.normal(size=1000) > 0).astype(np.float32)
    x_cal, y_cal = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (x_cal, y_cal))
    # the calibration draw's noise injected, so that s = 1 is scored on the
    # same latent samples as the chosen scale
    cal_noise = pls7.basis.sample_predictive_noise(trained7, x_cal, generator=3)
    temper = pt.TemperPLSClassification(x_cal, y_cal, pls7, trained7, generator=3,
                                        predictive_noise=cal_noise)
    f_cal = temper._latent_samples(x_cal, cal_noise)
    nll_one = float(_bernoulli_nll(temper._tempered_probs(f_cal, 1.0), y_cal))
    nll_chosen = temper.calibration_nll
    require(nll_chosen <= nll_one, f"tempered NLL {nll_chosen} above the untempered {nll_one}")
    log(f"  (f) Dirichlet targets, class-1 exact GP with fixed noise on N={x7.shape[0]}: "
        f"{1e3 * gp7_s / GP_EPOCHS11:.1f} ms/epoch, -MLL/N {losses7[0]:.4f} -> {losses7[-1]:.4f}, "
        f"outputscale {float(gp7.kernel.outputscale):.3f}; TemperPLSClassification scale "
        f"{temper.scale:.4f}: calibration NLL {nll_chosen:.5f} <= {nll_one:.5f} at s = 1")
    log(f"  calibration models {1e3 * calib_s:.1f} ms")
    launches = sum(c["gram"] for c in (gp_launches, svgp_launches, build_launches,
                                        train_launches, gp7_launches))
    return {"gram": launches, "spectral": train_launches["spectral"],
            "backward": gp_backward + svgp_backward, "backward_ms": backward_times}


# --------------------------------------------------------------------------
# phase 12: slice 5, scale-out, on a one-rank mesh
# --------------------------------------------------------------------------
STEPS12, T_BIT12, PARTIAL_ROWS12 = 2000, 20, N // 2
# (b) B5's partial mode over two row halves, summed, then the update,
# against the fused step: fp32 with the sums over N in another order, as
# phase 9's kernel against its plain version (U_TOL9, normwise)
# (c), (d) energies of two column shards summed against the whole run's:
# fp32 partial sums added in another order (phase 6's E_RTOL); (d) particles
# of two shards against the whole run: the same draws, products summed over
# other split-K slices when the shard is narrower (phase 6's W_TOL, normwise)
# (c) the finite patience: the first of these whose stop, replayed on the
# infinite-patience run's trace, falls inside the run
PATIENCES12 = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1)
# (d) the same for B3 and B4 in steps: the first (k + 1/2) eta that stops the
# run inside it (the half step keeps the stop off the boundary sim_time =
# patience, where fp32 sums of eta may fall either side); B3 at phase 6's
# shape runs 2000 steps, since its energy still falls at each of the first 200
STOP_STEPS12 = (1, 2, 4, 8, 16, 32, 64)


def phase_scale_out(pt, counters, fused_call, smi):
    """parallel/ on a world-size-1 NCCL group and a 1 x 1 mesh: (a) B5 steps
    under parallel_langevin_steps, (b) B5's partial mode, (c) B1 under
    parallel_train_pls and on two column shards, (d) B3 and B4 on two column
    shards, (e) mesh-sharded chunked serving, (f) the WDBC demo twin."""
    import torch.distributed as dist

    from projected_langevin_sampling_torch.parallel import make_mesh

    mesh = make_mesh(device="cuda")
    try:
        require(tuple(mesh.shape) == (1, 1) and dist.get_backend() == "nccl",
                f"mesh {tuple(mesh.shape)} on {dist.get_backend()}")
        ones = torch.ones(4, device="cuda")
        dist.all_reduce(ones, group=mesh.get_group("particles"))
        require(bool((ones == 1).all()), "NCCL all_reduce over a group of one")
        log(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on a world-size-1 "
            f"{dist.get_backend()} group; card {smi}")
        return _scale_out(pt, counters, fused_call, mesh)
    finally:
        dist.destroy_process_group()


def _two_shards(run, width):
    """``run(j0, shard)`` on columns 0 .. width and width .. 2 width, and on
    the whole; returns (whole, [shard 0, shard 1])."""
    whole = run(0, None)
    return whole, [run(j0, (j0, 2 * width)) for j0 in (0, width)]


def _global_stop_on_two_shards(run, width, steps, eta, whole, shards):
    """parallel_train_pls's early stop (``parallel/auto.train_to_global_stop``)
    on two column shards in this process, each rank's all-reduce played by
    adding the other shard's energies, against the whole run at a patience
    that stops it inside the run: the same stop step, the particles within
    W_TOL. ``run(j0, shard, steps, patience)``; ``whole`` and ``shards`` are
    its infinite-patience runs. Returns (patience, stop, max|dU|, max|U|)."""
    from projected_langevin_sampling_torch.parallel.auto import train_to_global_stop
    from projected_langevin_sampling_torch.training import TrainResult
    from projected_langevin_sampling_torch.utils.early_stopper import replay_early_stopper

    trace = whole[1].double()
    stops = {k: int(replay_early_stopper(trace, eta, (k + 0.5) * eta)[1]) for k in STOP_STEPS12}
    k = next((k for k, stop in stops.items() if 2 <= stop < steps), None)
    require(k is not None, f"no patience stops the run inside it: {stops}")
    patience = (k + 0.5) * eta
    want = run(0, None, steps, patience)
    got = [train_to_global_stop(
        lambda n, j0=j0: TrainResult(*run(j0, (j0, 2 * width), n, math.inf)),
        steps, eta, patience, lambda e, other=shards[1 - i][1]: e + other)
        for i, j0 in enumerate((0, width))]
    stop = int(want[3])
    require(stop < steps and all(int(r.steps_run) == stop for r in got),
            f"global stop {[int(r.steps_run) for r in got]} against the whole run's {stop}")
    scale = float(want[0].abs().max())
    err = float((torch.cat([r.particles for r in got], dim=1) - want[0]).abs().max())
    require(err <= W_TOL * scale, f"global stop particles: max|dU| {err} of {scale}")
    return patience, stop, err, scale


def _scale_out(pt, counters, fused_call, mesh):
    from projected_langevin_sampling_torch.ops.cuda import fused_update as fused
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen
    from projected_langevin_sampling_torch.ops.cuda import quadratic_train as quad
    from projected_langevin_sampling_torch.ops.cuda import spectral_train as spec
    from projected_langevin_sampling_torch.parallel import (
        parallel_langevin_steps,
        parallel_langevin_steps_with_noise,
        parallel_train_pls,
    )
    from projected_langevin_sampling_torch.training import spectral_system_host
    from projected_langevin_sampling_torch.utils.columns import ColumnShard
    from projected_langevin_sampling_torch.utils.early_stopper import replay_early_stopper

    x, y, z = headline_inputs(torch.float32)
    x_test = torch.linspace(-3, 3, N_TEST, device="cuda")[:, None]
    out = {}

    # (a) B5 steps: the IPB Bernoulli cell of phase 10
    ipb = headline_ipb(pt, x, z)
    _, labels, _, _ = classification_inputs()
    cost = pt.BernoulliCost(y_train=labels)
    particles = ipb.initialise_particles(J, generator=0)
    gen_z = torch.Generator(device="cuda").manual_seed(12)
    normals = torch.randn((T_BIT12, M, J), generator=gen_z, device="cuda")
    update_noise = torch.stack([ipb.sample_update_noise(J, normals=n) for n in normals])
    got = parallel_langevin_steps_with_noise(mesh, ipb, cost, particles, update_noise, STEP_SIZE)
    want = pt.langevin_steps(ipb, cost, particles, 0, STEP_SIZE, T_BIT12, fast_path="off",
                             noise=normals)
    require(torch.equal(got, want), "parallel_langevin_steps_with_noise is not langevin_steps")
    (stepped, _), steps_s, counts = run_counted(
        counters, lambda: parallel_langevin_steps(mesh, ipb, cost, particles, 0, STEP_SIZE,
                                                  STEPS12))
    require(counts["fused"] == STEPS12, f"parallel_langevin_steps launched B5 {counts['fused']} "
                                        f"times, not {STEPS12}")
    require(bool(torch.isfinite(stepped).all()), "parallel_langevin_steps particles")
    accuracy = predict_accuracy(pt.PLS(ipb, cost), stepped, x_test)
    _, single_s, _ = run_counted(counters, lambda: pt.langevin_steps(
        ipb, cost, particles, 0, STEP_SIZE, STEPS12, fast_path="off"))
    out["steps"] = counts
    log(f"  (a) {T_BIT12} injected-noise steps equal langevin_steps bit for bit; "
        f"parallel_langevin_steps {STEPS12} steps {1e3 * steps_s:.1f} ms = "
        f"{1e3 * steps_s / STEPS12:.4f} ms/step against langevin_steps "
        f"{1e3 * single_s / STEPS12:.4f} ms/step in this phase; accuracy {accuracy:.4f} "
        f"(threshold {ACCURACY_MIN10}); launches {counts}")
    require(accuracy > ACCURACY_MIN10, f"parallel_langevin_steps accuracy {accuracy}")

    # (b) B5's partial mode on two row halves, summed, then the update
    args, kw, phase9_out = fused_call
    p, d, y_b, u, prior, noise, kind = args
    again = fused.fused_update(*args, **kw)
    require(torch.equal(again, phase9_out), "the fused mode changed against phase 9's call")
    rows = (slice(0, PARTIAL_ROWS12), slice(PARTIAL_ROWS12, N))
    dkw = dict(params=kw["params"], mean_shift=kw["mean_shift"])
    halves = [(p[r].contiguous(), d[r].T.contiguous().T, y_b[r].contiguous()) for r in rows]
    fused.fused_drift.launches = 0
    drift = sum(fused.fused_drift(ph, dh, yh, u, kind, **dkw) for ph, dh, yh in halves)
    split = fused.apply_drift(u, drift, prior, noise, kw["eta"])
    torch.cuda.synchronize()
    require(fused.fused_drift.launches == 2, "the partial mode did not launch")
    err_b = float((split - again).abs().max())
    scale_b = float(again.abs().max())
    require(err_b <= U_TOL9[kind] * scale_b, f"partial mode disagrees: {err_b} of {scale_b}")
    half_ms = cuda_ms(lambda: fused.fused_drift(*halves[0], u, kind, **dkw), reps=20, warmup=2)
    whole_ms = cuda_ms(lambda: fused.fused_update(*args, **kw), reps=20, warmup=2)
    out["partial_max_abs_err"] = err_b
    log(f"  (b) B5 partial mode, N split {PARTIAL_ROWS12} + {N - PARTIAL_ROWS12}, summed, then "
        f"the update, against the fused step: max|dU| {err_b:.3e} (max|U| {scale_b:.2f}, "
        f"tolerance {U_TOL9[kind]} normwise); fused mode bit for bit phase 9's output; "
        f"partial call on {PARTIAL_ROWS12} rows {half_ms:.4f} ms, fused call {whole_ms:.4f} ms")

    # (c) B1 under parallel_train_pls: the ONB Gaussian auto (spectral) tier
    onb = headline_basis(pt, x, z)
    gcost = pt.GaussianCost(y_train=y, observation_noise=torch.tensor(0.1, device="cuda"))
    pls = pt.PLS(onb, gcost)
    u0 = pls.initialise_particles(J, generator=0)
    res, train_s, counts = run_counted(counters, lambda: parallel_train_pls(
        mesh, pls, particles=u0, number_of_epochs=STEPS, step_size=STEP_SIZE, generator=0))
    require(counts["spectral"] == 1, f"parallel_train_pls launched B1 {counts['spectral']} times")
    want_u, want_e = pt.train_pls(pls, u0, STEPS, STEP_SIZE, generator=0)
    require(torch.equal(res.particles, want_u), "parallel_train_pls is not train_pls bit for bit")
    energies = res.energies.tolist()
    require(len(want_e) == STEPS and energies == want_e, "parallel_train_pls energies")
    out["train"] = counts
    sigma, q_in, _, b_rot, e_const = spectral_system_host(onb, gcost)
    w0 = (q_in.T @ u0).contiguous()
    b1kw = dict(eta=STEP_SIZE, patience=math.inf, e_const=e_const, num_steps=STEPS,
                noise_scale=math.sqrt(2 * STEP_SIZE), seed=12345)
    b1 = lambda j0, sh: spec.spectral_train(  # noqa: E731
        w0 if sh is None else w0[:, j0:j0 + J // 2].contiguous(), 1 - STEP_SIZE * sigma,
        STEP_SIZE * b_rot, sigma, b_rot, **b1kw, shard=None if sh is None else ColumnShard(*sh))
    whole, shards = _two_shards(b1, J // 2)
    torch.cuda.synchronize()
    require(torch.equal(torch.cat([s[0] for s in shards], dim=1), whole[0]),
            "B1 on two column shards is not the whole run's W bit for bit")
    e_err = float(((shards[0][1] + shards[1][1] - whole[1]).abs() / whole[1].abs()).max())
    require(e_err <= E_RTOL, f"B1 shard energies {e_err}")
    trace = res.energies.double()
    stops = {pat: int(replay_early_stopper(trace, STEP_SIZE, pat)[1]) for pat in PATIENCES12}
    patience = next((pat for pat, st in stops.items() if 100 <= st <= STEPS - 100), None)
    require(patience is not None, f"no patience stops the run mid-way: {stops}")
    res_p = parallel_train_pls(mesh, pls, particles=u0, number_of_epochs=STEPS,
                               step_size=STEP_SIZE, early_stopper_patience=patience, generator=0)
    want_pu, want_pe = pt.train_pls(pls, u0, STEPS, STEP_SIZE, early_stopper_patience=patience,
                                    generator=0)
    stop = int(res_p.steps_run)
    require(stop == len(want_pe) + 1 and torch.equal(res_p.particles, want_pu),
            f"stop {stop} against train_pls's {len(want_pe) + 1}")
    log(f"  (c) parallel_train_pls (auto = spectral, B1) {STEPS} steps {1e3 * train_s:.1f} ms = "
        f"{1e3 * train_s / STEPS:.5f} ms/step, particles and energies equal to train_pls bit "
        f"for bit; launches {counts}. B1 on columns 0..{J // 2} and {J // 2}..{J} "
        f"(j0 = 0, {J // 2}): W bit "
        f"for bit the whole run's, shard energies summed max rel err {e_err:.3e}; patience "
        f"{patience}: stop at step {stop} of {STEPS}, the same as train_pls")

    # (d) B3 and B4 on two column shards, and the run's early stop on them
    prob = synthetic_general("bernoulli_sigmoid_smoothed", n=N6, m_k=M6, j=J6)
    b3kw = {k: v for k, v in prob.items() if k != "u0"}
    b3 = lambda j0, sh, steps=STEPS12, patience=math.inf: gen.general_train(  # noqa: E731
        u0=prob["u0"] if sh is None else prob["u0"][:, j0:j0 + J6 // 2].contiguous(), **b3kw,
        eta=ETA6, patience=patience, num_steps=steps, seed=7,
        shard=None if sh is None else ColumnShard(*sh))
    ipb_args, ipb_kw = quadratic_args(ipb, pt.GaussianCost(
        y_train=y, observation_noise=torch.tensor(0.1, device="cuda")))
    u4 = ipb.initialise_particles(J, generator=3)
    b4 = lambda j0, sh, steps=STEPS12, patience=math.inf: quad.quadratic_train(  # noqa: E731
        *ipb_args, u4 if sh is None else u4[:, j0:j0 + J // 2].contiguous(), **ipb_kw,
        eta=STEP_SIZE, patience=patience, num_steps=steps, seed=7,
        shard=None if sh is None else ColumnShard(*sh))
    for label, run, width, eta in (("B3", b3, J6 // 2, ETA6), ("B4", b4, J // 2, STEP_SIZE)):
        whole, shards = _two_shards(run, width)
        torch.cuda.synchronize()
        scale = float(whole[0].abs().max())
        err = float((torch.cat([s[0] for s in shards], dim=1) - whole[0]).abs().max())
        e_err = float(((shards[0][1] + shards[1][1] - whole[1]).abs() / whole[1].abs()).max())
        require(err <= W_TOL * scale and e_err <= E_RTOL,
                f"{label} on two column shards: max|dU| {err} of {scale}, energies {e_err}")
        patience, stop, stop_err, stop_scale = _global_stop_on_two_shards(
            run, width, STEPS12, eta, whole, shards)
        log(f"  (d) {label} on columns 0..{width} and {width}..{2 * width} (j0 = 0, {width}), "
            f"{STEPS12} steps: max|dU| against the whole run {err:.3e} (max|U| {scale:.2f}, "
            f"tolerance {W_TOL} normwise), shard energies summed max rel err {e_err:.3e}; "
            f"the run's stop on the two shards (train_to_global_stop) at patience "
            f"{patience:.3g}: step {stop} of {STEPS12}, the whole run's, max|dU| {stop_err:.3e} "
            f"(max|U| {stop_scale:.2f})")

    # (e) mesh-sharded chunked serving, against the single-device chunked call
    samples, mesh_s, counts = run_counted(counters, lambda: pls.predict_samples(
        res.particles, x_test, generator=0, chunk_size=CHUNK, mesh=mesh))
    single, single_s, single_counts = run_counted(counters, lambda: pls.predict_samples(
        res.particles, x_test, generator=0, chunk_size=CHUNK))
    require(counts["gram"] >= 2 and counts == single_counts,
            f"the mesh predict launched {counts}, the single-device call {single_counts}")
    err_e = float((samples - single).abs().max())
    scale_e = float(single.abs().max())
    require(tuple(samples.shape) == (N_TEST, J) and err_e <= 1e-5 * scale_e,
            f"mesh predict disagrees: {err_e} of {scale_e}")
    out["predict"] = counts
    log(f"  (e) predict_samples(mesh=) N*={N_TEST} chunk {CHUNK}: {1e3 * mesh_s:.1f} ms against "
        f"the single-device chunked call's {1e3 * single_s:.1f} ms; max|d| {err_e:.3e} (max "
        f"{scale_e:.2f}; bit for bit: {bool(torch.equal(samples, single))}); launches {counts}")

    # (f) the WDBC classification demo twin, on the card
    t0 = time.perf_counter()
    accuracy = runpy.run_path(os.path.join(ROOT, "examples", "classification_demo_torch.py"))[
        "main"]()
    require(accuracy > 0.9, f"WDBC demo accuracy {accuracy}")
    log(f"  (f) examples/classification_demo_torch.py on the card: accuracy {accuracy:.4f} "
        f"(threshold 0.9) in {time.perf_counter() - t0:.1f} s")
    return out


class B1Calls:
    """Every call made to B1's wrapper (``training.spectral_train``) while
    installed: its particles, coefficients and keywords, and the steps it
    ran; :meth:`hold` then holds B1 to its plain version on them. With
    ``first_of_shape`` only the first call of each (M, J, T) is recorded and
    later ones go straight to the wrapper: the profiler's warm-up call is
    recorded and the timed call of the same shape that follows it is not."""

    def __init__(self, training, first_of_shape=False):
        self.training, self.wrapper, self.calls = training, training.spectral_train, []
        self.first_of_shape, self.shapes = first_of_shape, set()

    def __call__(self, w0, decay, shift, energy_sigma, b_rot, **kw):
        shape = (*w0.shape, kw["num_steps"])
        if self.first_of_shape and shape in self.shapes:
            return self.wrapper(w0, decay, shift, energy_sigma, b_rot, **kw)
        self.shapes.add(shape)
        inputs = (w0.detach().clone(), tuple(c.detach().clone() for c in (
            decay, shift, energy_sigma, b_rot)), kw)
        out = self.wrapper(w0, decay, shift, energy_sigma, b_rot, **kw)
        self.calls.append((*inputs, int(out[3])))
        return out

    def install(self):
        self.training.spectral_train = self

    def remove(self):
        self.training.spectral_train = self.wrapper

    def hold(self, spec):
        """B1 at every (M, J, T) the calls gave it (phase 3 (a)'s zero-noise
        check and tolerances), and on each call's own particles,
        coefficients, noise scale and seed for 64 noisy steps (phase 3
        (d)'s), or for the steps the call ran before it stopped: a step-size
        search's larger steps may diverge (eta sigma > 2), and 64 steps of
        such a chain leave fp32's range."""
        shapes = {}
        for w0, _, kw, _ in self.calls:
            shapes.setdefault((*w0.shape, kw["num_steps"]), w0)
        for (m, j, steps), w0 in sorted(shapes.items()):
            hold_spectral_zero_noise(spec, w0.float(), steps,
                                     f"B1 zero noise at the main's M={m}, J={j}, T={steps}")
        for i, (w0, coeffs, kw, steps_run) in enumerate(self.calls):
            phase_spectral_noisy(spec, w0.float(), steps=max(1, min(64, steps_run)),
                                 seed=kw["seed"], eta=kw["eta"],
                                 coeffs=tuple(c.float() for c in coeffs),
                                 noise_scale=kw["noise_scale"],
                                 label=f"B1 noisy on the main's call {i + 1} of {len(self.calls)} "
                                 f"({steps_run} steps run)")


# --------------------------------------------------------------------------
# phase 13: slice 6, the UCI harness's regression and classification mains
# --------------------------------------------------------------------------
# the real row counts of kin8nm and rice (experiments/uci/fetch_datasets.py:53, :60),
# written by the port's synthetic generator
ROWS13 = {"kin8nm": 8192, "rice": 3810}
# (source config, its depth cut) of each main: the README's headline configs
CONFIGS13 = {
    "regression": ("experiments/uci/regression/config_precond_map.yaml",
                   "experiments_torch/uci/regression/config_precond_map_short.yaml"),
    "classification": ("experiments/uci/classification/config_precond_smooth.yaml",
                       "experiments_torch/uci/classification/config_precond_smooth_short.yaml"),
}
DEPTH_KEYS13 = {("kernel", "number_of_epochs"), ("svgp", "number_of_epochs"),
                ("pls", "maximum_number_of_steps"), ("pls", "number_of_step_searches")}
# pls-onb's test MSE (regression) and test accuracy (classification), on
# the normalised targets. A CPU run of the same mains on the same data (the
# card's machine, --device cpu) gave 0.0457 and 0.7795; the card's first
# run 0.0330 and 0.7927, with other draws. The MSE limit is twice the CPU
# run's (an untrained model, as the SVGP at this depth, gives 0.99); the
# accuracy limit is 0.70, four binomial spreads (0.021 on 381 test points)
# below the CPU run (the SVGP at this depth: 0.54)
MSE_MAX13, ACCURACY_MIN13 = 0.09, 0.70
# pls-student-onb's test MSE without its extra predictive noise. At 8192
# rows the Student-T fit to the subsample GPs' residuals gives df = 1.53: the
# extra predictive noise (a t of that df) has no variance, so the reported
# MSE, a mean over J = 100 particles of one draw, spread from 3.8 to 136.3
# over 8 draws on the card and 8 on the CPU (the JAX main's key-0 draws:
# 2.39-2.54) and has no limit here. The trained particles' own prediction
# has: 0.0642 in a CPU run of the same data and GP fits, 0.0749 on the
# card; the limit is twice the CPU run's (scripts/uci_pls_seeds.py --draws 8)
STUDENT_MSE_MAX13 = 0.13


def short_config13(main_name, configs=CONFIGS13, depth_keys=DEPTH_KEYS13):
    """The depth-cut config of a main, checked to differ from its source in
    the depth keys only; each cut is printed."""
    from experiments_torch.config import load_config

    source_path, short_path = configs[main_name]
    source = load_config(os.path.join(ROOT, source_path))
    short = load_config(os.path.join(ROOT, short_path))
    require(list(short) == list(source) and all(list(short[s]) == list(source[s])
                                               for s in source),
            f"{short_path} has other sections or keys than {source_path}")
    cuts = {(s, k) for s in source for k in source[s] if short[s][k] != source[s][k]}
    require(cuts <= depth_keys, f"{short_path} changes more than depth: {sorted(cuts)}")
    for s, k in sorted(cuts):
        log(f"  cut: {s}.{k} {source[s][k]} -> {short[s][k]} ({source_path})")
    return short


def read_results13(results, models, expected):
    """``{(model, file): value}`` of every per-model CSV the main should
    have written; a missing file raises."""
    values = {}
    for model in models:
        for metric in expected(model):
            for split in ("train", "test"):
                path = os.path.join(results, model, f"{metric}_{split}.csv")
                require(os.path.exists(path), f"the main wrote no {path}")
                with open(path) as f:
                    header, row = f.read().splitlines()[:2]
                require(header == f"dataset,{model}", f"{path}: header {header!r}")
                cell = row.split(",")[1]
                values[(model, f"{metric}_{split}")] = math.nan if cell == "" else float(cell)
    return values


def phase_harness(counters):
    """The two UCI mains of ``experiments_torch`` through ``main(...)``, at
    the datasets' real row counts, their configs cut in depth only, in fp64
    on the card: (a) regression on kin8nm, (b) classification on rice."""
    import tempfile

    from experiments_torch.data import ExperimentData, ProblemType
    from experiments_torch.metrics import calculate_mse, concatenate_seed
    from experiments_torch.uci import make_synthetic_datasets
    from experiments_torch.uci.classification import main as classification
    from experiments_torch.uci.regression import main as regression
    from projected_langevin_sampling_torch import training
    from projected_langevin_sampling_torch.models.pls import PLS
    from projected_langevin_sampling_torch.ops.cuda import spectral_train as spec
    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram

    # every call the mains make to B1's wrapper, to hold B1 at the main
    # path's shapes and on its inputs after (a)
    b1_calls = B1Calls(training)
    b1_calls.install()
    # the plain PLS models the regression main scores, for pls-student-onb's
    # check without its extra predictive noise
    scored, calculate_metrics = {}, regression.calculate_metrics

    def recording_metrics(model, experiment_data, model_name, **kw):
        scored[model_name] = (model, kw.get("particles"), experiment_data.test)
        return calculate_metrics(model=model, experiment_data=experiment_data,
                                 model_name=model_name, **kw)

    regression.calculate_metrics = recording_metrics
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    try:
        datasets = os.path.join(tmp, "datasets")
        for name, rows in ROWS13.items():
            make_synthetic_datasets.main(rows, datasets, names=[name])
        sections = {"data": "data_config", "kernel": "kernel_config",
                    "inducing_points": "inducing_points_config", "pls": "pls_config",
                    "svgp": "svgp_config", "metrics": "metrics_config"}
        out = {}

        def run(main_module, main_name, dataset):
            config = short_config13(main_name)
            outputs = os.path.join(tmp, main_name)
            ARDGram.backward_calls = 0
            _, seconds, launches = run_counted(counters, lambda: main_module.main(
                data_seed=0, dataset_name=dataset, outputs_path=outputs, datasets_dir=datasets,
                device="cuda", dtype=torch.float64,
                **{arg: config[k] for k, arg in sections.items()}))
            backward = ARDGram.backward_calls
            concatenate_seed(outputs, 0, [dataset], main_module.MODEL_NAMES, main_module.METRICS)
            log(f"  {main_name} main on {dataset} ({ROWS13[dataset]} rows): {seconds:.1f} s; "
                f"launches {launches}, B2 backward passes {backward}")
            return outputs, launches, backward, config

        # (a) regression: 12 models, on B1 (pls-onb's step-size candidates)
        # and B2 (the GP fits forward and backward, every build and predict)
        outputs, launches_a, backward_a, config = run(regression, "regression", "kin8nm")
        results = os.path.join(outputs, "0", "results", "kin8nm")
        values = read_results13(
            results, regression.MODEL_NAMES,
            lambda m: ("mae", "mse", "nll") + (
                ("coverage", "median_interval_width", "average_interval_width")
                if m.endswith("conformalise") else ()))
        # the conformal NLL scores a Gaussian whose std is half the 2/3
        # interval; where the conformal correction is negative it can close an
        # interval to zero width at a point, and the NLL is NaN, in the JAX
        # harness as here (tests/test_torch_harness_regression.py)
        for (model, name), value in values.items():
            require(math.isfinite(value) or (model.endswith("conformalise") and name.startswith(
                "nll") and math.isnan(value)), f"{model} {name} = {value}")
        nan_nll = sorted(f"{m} {n}" for (m, n), v in values.items() if math.isnan(v))
        for table in ("mae", "mse", "nll"):
            for split in ("train", "test"):
                require(os.path.exists(os.path.join(outputs, "0", "results",
                                                    f"{table}_{split}.csv")),
                        f"no joined {table}_{split}.csv")
        data = ExperimentData.load(os.path.join(outputs, "0", "data", "kin8nm",
                                                "experiment_data.pkl"),
                                   ProblemType.REGRESSION, device="cpu")
        n_test, n_val = data.test.x.shape[0], data.validation.x.shape[0]
        coverage = config["metrics"]["coverage"]
        # phase 11's band at this run's n_test and n_val
        spread = math.sqrt(coverage * (1 - coverage) * (1 / n_test + 1 / (n_val + 2)))
        band = (coverage - 4 * spread, coverage + 1 / (n_val + 1) + 4 * spread)
        coverages = {m: values[(m, "coverage_test")] for m in regression.MODEL_NAMES
                     if m.endswith("conformalise")}
        for model, value in coverages.items():
            require(band[0] <= value <= band[1],
                    f"{model} test coverage {value} outside [{band[0]:.4f}, {band[1]:.4f}]")
        mse = values[("pls-onb", "mse_test")]
        require(mse < MSE_MAX13, f"pls-onb test MSE {mse} >= {MSE_MAX13}")
        student, particles, test = scored["pls-student-onb"]
        extra = student.basis.additional_predictive_noise_distribution
        bare = PLS(basis=student.basis.replace(additional_predictive_noise_distribution=None),
                   cost=student.cost)
        student_mse = calculate_mse(bare(x=test.x, particles=particles, generator=0), test.y)
        require(student_mse < STUDENT_MSE_MAX13,
                f"pls-student-onb test MSE without its extra noise {student_mse} >= "
                f"{STUDENT_MSE_MAX13}")
        require(launches_a["spectral"] >= 1 and launches_a["gram"] >= 1 and backward_a >= 1,
                f"regression main: B1 {launches_a['spectral']}, B2 {launches_a['gram']}, "
                f"B2 backward {backward_a}")
        b1_calls.hold(spec)
        log(f"  (a) {len(values)} values of 12 models, finite"
            + (f" but the conformal NLL {nan_nll} (a zero-width 2/3 interval)" if nan_nll else "")
            + f"; test coverage of the {coverage} intervals (n_test {n_test}, n_val {n_val}, band "
            f"[{band[0]:.4f}, {band[1]:.4f}]): "
            + ", ".join(f"{m} {v:.4f}" for m, v in coverages.items())
            + f"; pls-onb test MSE {mse:.5f} (limit {MSE_MAX13}), svgp "
            f"{values[('svgp', 'mse_test')]:.5f}; pls-student-onb "
            f"{values[('pls-student-onb', 'mse_test')]:.5f} (extra predictive noise a t of df "
            f"{extra.df:.4g}), without its extra noise {student_mse:.5f} (limit "
            f"{STUDENT_MSE_MAX13})")

        # (b) classification: pls-onb (the residual-smoothed Bernoulli cost on
        # the off tier) and svgp, on B2
        outputs, launches_b, backward_b, _ = run(classification, "classification", "rice")
        values = read_results13(os.path.join(outputs, "0", "results", "rice"),
                                classification.MODEL_NAMES,
                                lambda m: ("acc", "auc", "f1", "nll", "mae", "mse"))
        for (model, name), value in values.items():
            require(math.isfinite(value), f"{model} {name} = {value}")
        accuracy = values[("pls-onb", "acc_test")]
        require(accuracy > max(ACCURACY_MIN13, ACCURACY_MIN10),
                f"pls-onb test accuracy {accuracy} <= {max(ACCURACY_MIN13, ACCURACY_MIN10)}")
        require(launches_b["gram"] >= 1 and launches_b["smoothed"] >= 1,
                f"classification main: B2 {launches_b['gram']}, Q1 {launches_b['smoothed']}")
        log(f"  (b) {len(values)} values, finite; pls-onb test accuracy {accuracy:.4f} (limit "
            f"{max(ACCURACY_MIN13, ACCURACY_MIN10)}), AUC {values[('pls-onb', 'auc_test')]:.4f}, "
            f"NLL {values[('pls-onb', 'nll_test')]:.4f}; svgp accuracy "
            f"{values[('svgp', 'acc_test')]:.4f}, NLL {values[('svgp', 'nll_test')]:.4f}")
        out = {k: launches_a[k] + launches_b[k] for k in launches_a}
        out["backward"] = backward_a + backward_b
        return out
    finally:
        b1_calls.remove()
        regression.calculate_metrics = calculate_metrics
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 14: slice 7, the curve mains, the Poisson study, the mixture summary
# and the profiler sweep
# --------------------------------------------------------------------------
# each piece's depth cut (scripts/curve_mains.py SHORT) may change only these
# keys of its source config, the JAX main's own
DEPTH_KEYS14 = {("kernel", "number_of_epochs"), ("kernel", "number_of_iterations"),
                ("svgp", "number_of_epochs"), ("pls", "maximum_number_of_steps"),
                ("profiler", "number_of_seeds")}
# Limits, each from a CPU run of the same piece, config and seed on the
# card's machine (python3 scripts/curve_mains.py --device cpu):
# - pls-onb's test MSE on curve 2 (normalised targets; the test split is the
#   held-out intervals, four of five at the edges, so it is an
#   extrapolation): CPU run 1.19 (Euler) and 1.94 (preconditioned); a model
#   predicting 0 scores about 1. The limit, 4.0, is twice the larger: a
#   diverged or untrained chain far off the data fails it.
# - the best PLS test accuracy of the classification main: CPU run 0.537 on
#   205 test points, mostly extrapolated, where the trained models are near
#   chance (train accuracy 0.83); the limit, 0.40, is four binomial spreads
#   (0.035) below it.
# - pls-onb's test NLL of the Poisson main: CPU run 3.69; the limit is twice.
# - the mixture summary: CPU run 19 and 31 particles of 50 in the two modes
#   and an estimated shift of 18.85 (true 20); the limits: at least 10 in
#   each mode, the shift within 15 to 25.
MSE_MAX14, ACCURACY_MIN14, NLL_MAX14 = 4.0, 0.40, 7.4
SHARE_MIN14, SHIFT_BAND14 = 10, (15.0, 25.0)


def phase_curves(counters):
    """The curve mains of ``experiments_torch`` on curve 2 through
    ``scripts/curve_mains.py``, their configs cut in depth only, fp64 on the
    card, each in a fresh directory: (a) the regression main on config.yaml
    (Euler) and config_precond.yaml, (b) the classification main, (c) the
    Poisson main and one cell of its study, (d) the mixture main and its
    summary, (e) the profiler's sweeps in fp32."""
    import tempfile

    from projected_langevin_sampling_torch import training
    from projected_langevin_sampling_torch.ops.cuda import spectral_train as spec
    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram

    curves = runpy.run_path(os.path.join(ROOT, "scripts", "curve_mains.py"))
    # every depth cut of slice 7, the ones the pieces run among them
    shorts = sorted(glob.glob(os.path.join(ROOT, "experiments_torch", "curves", "*",
                                           "config*_short.yaml")))
    shorts.append(os.path.join(ROOT, curves["SHORT"]["profiler"]))
    configs = {os.path.relpath(p, ROOT): (
        os.path.relpath(p, ROOT).replace("experiments_torch", "experiments", 1).replace(
            "_short.yaml", ".yaml"), os.path.relpath(p, ROOT)) for p in shorts}
    require(set(curves["SHORT"].values()) <= set(configs) and len(configs) == 9,
            f"slice 7's depth cuts: {sorted(configs)}")
    for name in configs:
        short_config13(name, configs, DEPTH_KEYS14)
    # every call the regression main makes to B1's wrapper, to hold B1 at
    # the main's shapes and on its inputs after (a)
    b1_calls, profiler_b1 = B1Calls(training), None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_curves_")
    totals = {"backward": 0}

    def run(label, fn):
        ARDGram.backward_calls = 0
        out, seconds, launches = run_counted(counters, lambda: fn(os.path.join(tmp, label)))
        backward = ARDGram.backward_calls
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        totals["backward"] += backward
        log(f"  {label}: {seconds:.1f} s; launches {launches}, B2 backward passes {backward}")
        return out, launches, backward

    def finite(values, what):
        for key, value in values.items():
            require(math.isfinite(value), f"{what} {key} = {value}")

    try:
        # (a) the regression main on both configs: pls-onb's candidates on
        # B1, every GP fit, build and predict on B2
        b1_calls.install()
        mses = {}
        for name in ("regression", "regression_precond"):
            out, launches, backward = run(name, lambda o, n=name: curves["run_regression"](
                n, o, "cuda"))
            mses[name] = out["mse_test"]
            require(out["mse_test"] < MSE_MAX14,
                    f"{name}: pls-onb test MSE {out['mse_test']} >= {MSE_MAX14}")
            require(launches["spectral"] >= 1 and launches["gram"] >= 1 and backward >= 1,
                    f"{name} main: B1 {launches['spectral']}, B2 {launches['gram']}, "
                    f"B2 backward {backward}")
        b1_calls.remove()
        b1_calls.hold(spec)
        log(f"  (a) pls-onb test MSE {mses['regression']:.5f} (Euler), "
            f"{mses['regression_precond']:.5f} (preconditioned); limit {MSE_MAX14}")

        # (b) the classification main: four PLS models on the off tier, the
        # SVGP, their metric files
        out, launches, backward = run("classification", lambda o: curves["run_classification"](
            o, "cuda"))
        finite(out["values"], "classification")
        require(out["best_accuracy"] > ACCURACY_MIN14,
                f"best PLS test accuracy {out['best_accuracy']} <= {ACCURACY_MIN14}")
        require(launches["gram"] >= 1 and backward >= 1,
                f"classification main: B2 {launches['gram']}, B2 backward {backward}")
        log(f"  (b) {len(out['values'])} values, finite; best PLS test accuracy "
            f"{out['best_accuracy']:.4f} (limit {ACCURACY_MIN14}); "
            + ", ".join(f"{m} {out['values'][(m, 'acc_test')]:.4f}"
                        for m in curves["PLS_CLASSIFIERS"] + ["svgp-c"]))

        # (c) the Poisson main, then one cell of its study on the same curve
        out, launches, _ = run("poisson_regression", lambda o: curves["run_poisson"](o, "cuda"))
        finite(out["values"], "poisson")
        require(out["nll_test"] < NLL_MAX14, f"pls-onb test NLL {out['nll_test']} >= {NLL_MAX14}")
        require(launches["gram"] >= 1, f"Poisson main: B2 {launches['gram']}")
        study, _, _ = run("study", lambda o: curves["run_study"](o, "cuda"))
        finite({tuple(r[k] for k in ("model", "metric", "split")): r["value"]
                for r in study["rows"]}, "study")
        require({r["model"] for r in study["rows"]} == {"pls-onb", "pls-onb-m0", "pls-ipb",
                                                        "svgp-gaussian"}, "study models")
        rows = {(r["model"], r["metric"]): r["value"] for r in study["rows"] if r["split"] == "test"}
        log(f"  (c) pls-onb test NLL {out['nll_test']:.4f} (limit {NLL_MAX14}), pls-ipb "
            f"{out['values'][('pls-ipb', 'nll_test')]:.4f}; the study's {len(study['rows'])} rows, "
            "finite; test NLL and rate RMSE: "
            + ", ".join(f"{m} {rows[(m, 'nll')]:.4f} / {rows[(m, 'rate_rmse')]:.4f}"
                        for m in ("pls-onb", "pls-onb-m0", "pls-ipb", "svgp-gaussian")))

        # (d) the mixture main, then its summary
        out, launches, _ = run("mixture_likelihood", lambda o: curves["run_mixture"](o, "cuda"))
        row = out["row"]
        require(os.path.exists(out["table"]), "the summary wrote no table")
        require(row["bimodal"] and min(row["n_lower"], row["n_upper"]) >= SHARE_MIN14,
                f"mixture modes {row['n_lower']} and {row['n_upper']}")
        require(SHIFT_BAND14[0] <= row["est_shift"] <= SHIFT_BAND14[1],
                f"estimated shift {row['est_shift']} outside {SHIFT_BAND14}")
        log(f"  (d) particles in the curve mode {row['n_lower']}, in the shifted mode "
            f"{row['n_upper']} (at least {SHARE_MIN14} each), estimated shift "
            f"{row['est_shift']:.4f} (true {row['true_shift']}, band {SHIFT_BAND14})")

        # (e) the profiler's sweeps in fp32: every PLS row is two spectral
        # runs (warm-up and timed), each one B1 launch at T <= 100. B1 is
        # held at every (M, J, T) the sweeps give it, on the warm-up call's
        # inputs of each (the timed calls are not recorded)
        profiler_b1 = B1Calls(training, first_of_shape=True)
        profiler_b1.install()
        out, launches, _ = run("profiler", lambda o: curves["run_profiler"](o, "cuda"))
        profiler_b1.remove()
        profiler_b1.hold(spec)
        count, pls_rows = 0, 0
        for axis, body in out["rows"].items():
            for _, value, _, model, ms in body:
                count += 1
                pls_rows += model == "pls"
                require(math.isfinite(float(ms)) and float(ms) > 0, f"profiler {axis} {value} {ms}")
        require(count == 70 and pls_rows == 40, f"profiler rows {count}, PLS {pls_rows}")
        require(launches["spectral"] >= 2 * pls_rows,
                f"profiler: B1 {launches['spectral']} launches for {pls_rows} PLS rows")
        medians = {axis: {model: float(np.median([float(r[4]) for r in body if r[3] == model]))
                          for model in {r[3] for r in body}}
                   for axis, body in out["rows"].items()}
        log(f"  (e) B1 held at the sweeps' {len(profiler_b1.shapes)} shapes (M, J, T): "
            + ", ".join(str(k) for k in sorted(profiler_b1.shapes)))
        log(f"  (e) {count} rows, finite and positive; median ms over each sweep: "
            + "; ".join(f"{axis} " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(m.items()))
                        for axis, m in medians.items()))
        return totals
    finally:
        b1_calls.remove()
        if profiler_b1 is not None:
            profiler_b1.remove()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 15: slice 8, the real sklearn-bundled data, the gap attribution, the
# SVGP audit, the ONB scalings and the parallel regression main
# --------------------------------------------------------------------------
# each piece's depth cut (scripts/slice8_tools.py SHORT) may change only these
# keys of its source config; the 1 x 1 config also the mesh (pls.parallel)
DEPTH_KEYS15 = DEPTH_KEYS13 | {("pls", "parallel")}
CONFIGS15 = {
    "regression": ("experiments/uci/regression/config_precond_map.yaml",
                   "experiments_torch/uci/regression/config_precond_map_real_short.yaml"),
    "classification": ("experiments/uci/classification/config_precond_smooth.yaml",
                       "experiments_torch/uci/classification/"
                       "config_precond_smooth_real_short.yaml"),
    "parallel": ("experiments/uci/regression/config_parallel.yaml",
                 "experiments_torch/uci/regression/config_parallel_1x1_short.yaml"),
}
# Limits, each from a CPU run of the same pieces on the same data
# (python3 scripts/slice8_tools.py --device cpu):
# - pls-onb's test MSE on diabetes_sklearn (normalised targets): CPU run
#   0.5033; the reference's ten seeds at full depth 0.4851 +- 0.0649
#   (RESULTS.md:239-300). 0.75 is four of those spreads above the reference
#   and fails an untrained model (a zero prediction scores about 1) and the
#   SVGP at this depth (0.8195).
# - pls-onb's test accuracy: CPU run 1.0 on wine_uci's 18 test points and
#   0.9649 on breast_wdbc's 57; each limit is four binomial spreads below it
#   (at p = 0.97 for wine_uci), above the majority class (0.67 and 0.63).
# - the SVGP audit's |NLL delta| (harness - rebuild): CPU run 0.0006 and
#   0.0118; the limit is four times the larger.
# - the ONB comparison's PLS test NLLs: CPU run at most 1.4931; a chain that
#   never found a stable step (every candidate diverged) scored 3.90; the
#   limit is twice the CPU's.
MSE_MAX15 = 0.75
ACCURACY_MIN15 = {"wine_uci": 0.83, "breast_wdbc": 0.87}
AUDIT_DELTA_MAX15, ONB_NLL_MAX15 = 0.05, 3.0
# the zero-noise hold's steps at most: the plain loop runs about 0.7 ms a step
B1_HOLD_STEPS15 = 4000


def phase_slice8(counters):
    """The pieces of ``scripts/slice8_tools.py``, fp64 on the card, each in
    a fresh directory: (a) the real frames, (b) the UCI mains on them, (c)
    the gap attribution, (d) the SVGP audit, (e) the ONB scalings on two
    curves, (f) the parallel regression main on a 1 x 1 mesh against the
    same main without it, (g) B1 on each shape's first call."""
    import tempfile

    from experiments_torch.compare_onb_scaling import jax_protocol_config
    from projected_langevin_sampling_torch import training
    from projected_langevin_sampling_torch.ops.cuda import spectral_train as spec
    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram

    tools = runpy.run_path(os.path.join(ROOT, "scripts", "slice8_tools.py"))
    require({k: v[1] for k, v in CONFIGS15.items()}.items() <= tools["SHORT"].items(),
            "phase 15's configs are slice8_tools.py's")
    for name in CONFIGS15:  # the audit's config_precond_map_short.yaml: phase 13
        short_config13(name, CONFIGS15, DEPTH_KEYS15)
    onb_source = jax_protocol_config(os.path.join(ROOT, "experiments", "curves", "regression",
                                                  "config.yaml"))
    onb_short = tools["config_of"]("onb_scaling")
    cuts = {(s, k) for s in onb_source for k in onb_source[s]
            if onb_short[s][k] != onb_source[s][k]}
    require(list(onb_short) == list(onb_source) and cuts <= DEPTH_KEYS14 | DEPTH_KEYS13,
            f"the ONB comparison's config changes more than depth: {sorted(cuts)}")
    for sec, key in sorted(cuts):
        log(f"  cut: {sec}.{key} {onb_source[sec][key]} -> {onb_short[sec][key]} "
            "(the JAX compare_onb_scaling protocol)")
    b1_calls = B1Calls(training, first_of_shape=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice8_")
    datasets = os.path.join(tmp, "datasets")
    totals = {"backward": 0}

    def run(label, fn):
        ARDGram.backward_calls = 0
        out, seconds, launches = run_counted(counters, lambda: fn(os.path.join(tmp, label)))
        backward = ARDGram.backward_calls
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        totals["backward"] += backward
        log(f"  {label}: {seconds:.1f} s; launches {launches}, B2 backward passes {backward}")
        return out, launches

    try:
        b1_calls.install()
        # (a) the real frames (and synthetic energy_cooling at its 768 rows)
        fetched, _ = run("fetch", lambda o: tools["write_inputs"](datasets))
        require(fetched["shapes"] == tools["SHAPES"],
                f"frames {fetched['shapes']} against the JAX script's {tools['SHAPES']}")
        log("  (a) rows and columns as the JAX script's: " + ", ".join(
            f"{n} {r}x{c}" for n, (r, c) in fetched["shapes"].items())
            + "; sha256 pins (experiments/uci/datasets/checksums.json): " + ", ".join(
            f"{n} {'match' if ok else 'differ'}" for n, ok in fetched["pins"].items()))

        # (b) the mains on the real sets: pls-onb on B1 (regression), every
        # GP fit, build and predict on B2
        reference = tools["REFERENCE"]
        out, launches = run("regression", lambda o: tools["run_regression"](datasets, o, "cuda"))
        values = out["values"]
        for (model, name), value in values.items():
            require(math.isfinite(value) or (model.endswith("conformalise") and name.startswith(
                "nll") and math.isnan(value)), f"regression {model} {name} = {value}")
        mse = values[("pls-onb", "mse_test")]
        require(mse < MSE_MAX15, f"diabetes_sklearn pls-onb test MSE {mse} >= {MSE_MAX15}")
        require(launches["spectral"] >= 1 and launches["gram"] >= 1,
                f"regression main: B1 {launches['spectral']}, B2 {launches['gram']}")
        log(f"  (b) diabetes_sklearn ({len(values)} values): " + "; ".join(
            f"{metric} pls-onb {values[('pls-onb', metric + '_test')]:.4f}, svgp "
            f"{values[('svgp', metric + '_test')]:.4f} (reference, 10 seeds at full depth: "
            f"{reference[('diabetes_sklearn', metric)][0]}, "
            f"{reference[('diabetes_sklearn', metric)][1]})" for metric in ("nll", "mse"))
            + f"; MSE limit {MSE_MAX15}")
        out, launches = run("classification",
                            lambda o: tools["run_classification"](datasets, o, "cuda"))
        require(launches["gram"] >= 1, f"classification main: B2 {launches['gram']}")
        for name, vals in out["values"].items():
            for (model, metric), value in vals.items():
                require(math.isfinite(value), f"{name} {model} {metric} = {value}")
            accuracy = vals[("pls-onb", "acc_test")]
            require(accuracy > ACCURACY_MIN15[name],
                    f"{name} pls-onb test accuracy {accuracy} <= {ACCURACY_MIN15[name]}")
            log(f"  (b) {name}: " + "; ".join(
                f"{metric} pls-onb {vals[('pls-onb', metric + '_test')]:.4f}, svgp "
                f"{vals[('svgp', metric + '_test')]:.4f} (reference: "
                f"{reference[(name, metric)][0]}, {reference[(name, metric)][1]})"
                for metric in ("acc", "nll"))
                + f"; accuracy limit {ACCURACY_MIN15[name]}")

        # (c) the gap attribution on (b)'s classification checkpoints
        out, _ = run("gap", lambda o: tools["run_gap"](os.path.join(tmp, "classification"), o,
                                                      "cuda"))
        rows = out["rows"]
        require(sorted(r["dataset"] for r in rows) == sorted(tools["CLASSIFICATION_SETS"]),
                f"gap rows {[r['dataset'] for r in rows]}")
        for r in rows:
            require(r["validated"], f"{r['dataset']}: the gate failed: pls {r['pls_nll']} vs "
                    f"{r['pls_nll_recorded']}, svgp {r['svgp_nll']} vs {r['svgp_nll_recorded']}")
            log(f"  (c) {r['dataset']}: validated (|pls - recorded| "
                f"{abs(r['pls_nll'] - r['pls_nll_recorded']):.2e}, |svgp - recorded| "
                f"{abs(r['svgp_nll'] - r['svgp_nll_recorded']):.2e}); delta {r['delta']:+.4f}, "
                f"MC std {r['pls_mc_std']:.4f}, recalibrated pls/svgp {r['pls_nll_recal']:.4f}/"
                f"{r['svgp_nll_recal']:.4f}, latent var pls/svgp {r['pls_latent_var']:.3f}/"
                f"{r['svgp_latent_var']:.3f}, extended ({r['extra_steps']} steps) "
                f"{r['pls_nll_extended']:.4f}")

        # (d) the SVGP audit: the harness's SVGP (B2) against the rebuild
        out, launches = run("audit", lambda o: tools["run_audit"](datasets, o, "cuda"))
        require(launches["gram"] >= 1, f"audit: B2 {launches['gram']}")
        for r in out["rows"]:
            delta = r["harness_nll"] - r["rebuild_nll"]
            require(all(math.isfinite(v) for v in r.values() if isinstance(v, float)),
                    f"audit {r}")
            require(abs(delta) <= AUDIT_DELTA_MAX15,
                    f"audit {r['dataset']}: NLL delta {delta} beyond {AUDIT_DELTA_MAX15}")
            log(f"  (d) {r['dataset']}: NLL harness {r['harness_nll']:.4f}, rebuild "
                f"{r['rebuild_nll']:.4f}, delta {delta:+.4f} (limit {AUDIT_DELTA_MAX15}); "
                f"noise {r['harness_noise']:.4f} / {r['rebuild_noise']:.4f}")

        # (e) the ONB scalings on two curves, both on B1
        out, launches = run("onb_scaling", lambda o: tools["run_onb_scaling"](o, "cuda"))
        require(len(out["rows"]) == len(tools["ONB_CURVES"]), f"ONB rows {out['rows']}")
        for r in out["rows"]:
            require(all(math.isfinite(r.get(c, math.nan)) for c in
                        ("reference_mse", "nystrom_mse", "svgp_mse", "reference_nll",
                         "nystrom_nll", "svgp_nll")), f"ONB row {r}")
            require(max(r["reference_nll"], r["nystrom_nll"]) < ONB_NLL_MAX15,
                    f"ONB {r['curve']}: PLS test NLL beyond {ONB_NLL_MAX15}")
        require(launches["spectral"] >= 2 * len(out["rows"]), f"ONB: B1 {launches['spectral']}")
        log("  (e) " + "; ".join(
            f"{r['curve']} NLL reference {r['reference_nll']:.4f}, nystrom {r['nystrom_nll']:.4f},"
            f" svgp {r['svgp_nll']:.4f}; MSE {r['reference_mse']:.4f}, {r['nystrom_mse']:.4f}, "
            f"{r['svgp_mse']:.4f}" for r in out["rows"]) + f"; counts {out['counts']}")

        # (f) config_parallel's protocol on a 1 x 1 mesh, NCCL, against the
        # main without the mesh: the pls* files bit for bit
        out, launches = run("parallel", lambda o: tools["run_parallel"](datasets, o, "cuda"))
        require(tuple(out["mesh"]) == (1, 1) and out["backend"] == "nccl",
                f"mesh {out['mesh']} on {out['backend']}")
        require(out["compared"] >= 40 and not out["differ"],
                f"parallel main: {out['differ']} of {out['compared']} pls* files differ")
        require(launches["spectral"] >= 2, f"parallel: B1 {launches['spectral']}")
        log(f"  (f) mesh {tuple(out['mesh'])} on a world-size-1 {out['backend']} group: "
            f"{out['compared']} pls* metric files equal the single-process main's bit for bit")

        # (g) B1 on each shape's first call in this phase
        b1_calls.remove()
        long_calls = [c for c in b1_calls.calls if c[2]["num_steps"] > B1_HOLD_STEPS15]
        for w0, _, kw, _ in long_calls:
            kw["num_steps"] = B1_HOLD_STEPS15
        b1_calls.hold(spec)
        log(f"  (g) B1 held at the phase's {len(b1_calls.shapes)} shapes (M, J, T): "
            + ", ".join(str(k) for k in sorted(b1_calls.shapes))
            + f"; zero-noise holds of the {len(long_calls)} calls longer than "
            f"{B1_HOLD_STEPS15} steps run their first {B1_HOLD_STEPS15}")
        return totals
    finally:
        b1_calls.remove()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 16: slice 9, the results pipeline over the UCI mains on real data
# --------------------------------------------------------------------------
# the mains of scripts/results_cards.py (its real short configs), on one real
# set each, over three data seeds: the regression main restricted to pls-onb
# and svgp, what the head-to-head and the real-data rollup need; the
# classification main, which has no models filter (as in the JAX package),
# runs all its models
SETS16, SEEDS16 = {"regression": "diabetes_sklearn", "classification": "wine_uci"}, (0, 1, 2)
MODELS16 = ("pls-onb", "svgp")
METRICS16 = {"regression": ("mae", "mse", "nll"), "classification": ("acc", "auc", "f1", "nll")}


def phase_results(counters, smi):
    """(a) The regression main on diabetes_sklearn and the classification
    main on wine_uci over data seeds 0-2 on the card, into a fresh root
    (``scripts/results_cards.py``'s ``run_main``); (b) ``aggregate_seeds``
    over both trees, n = 3 in every test cell; (c) ``make_results_summary``
    over the root: both sets named in the head-to-head and the rollup, the
    long CSV giving back every per-seed value exactly, the tables rendered
    from the long CSV alone equal to those from the tree, and pls-onb's
    per-seed test MSE and accuracy inside phase 15's limits."""
    import tempfile

    from experiments_torch import aggregate_seeds, make_results_summary
    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram

    cards = runpy.run_path(os.path.join(ROOT, "scripts", "results_cards.py"))
    require({m: cards["MAINS"][m]["config"] for m in SETS16}
            == {m: CONFIGS15[m][1] for m in SETS16},
            "results_cards.py's configs are phase 15's real short configs")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_results_")
    try:
        datasets = os.path.join(tmp, "datasets")
        cards["write_datasets"](datasets)

        # (a) the mains, counted
        def mains():
            records = []
            for main_name, dataset in SETS16.items():
                for seed in SEEDS16:
                    records.append(cards["run_main"](
                        main_name, dataset, seed, tmp, datasets, "cuda",
                        models=set(MODELS16) if main_name == "regression" else None))
            return records

        ARDGram.backward_calls = 0
        records, seconds, launches = run_counted(counters, mains)
        launches["backward"] = ARDGram.backward_calls
        for r in records:
            log(f"  (a) {r['main']} {r['dataset']} seed {r['seed']}: {r['seconds']:.1f} s, "
                f"B1 {r['b1_launches']}, B2 {r['b2_launches']}, step size {r['step_size']}")
        require(launches["spectral"] >= len(SEEDS16) and launches["gram"] >= 1
                and launches["backward"] >= 1,
                f"phase 16's mains: B1 {launches['spectral']}, B2 {launches['gram']}, "
                f"B2 backward passes {launches['backward']}")
        values = {}
        for main_name, dataset in SETS16.items():
            tree = cards["tree"](tmp, main_name)
            for seed in SEEDS16:
                for model in MODELS16:
                    for metric in METRICS16[main_name]:
                        for split in ("train", "test"):
                            path = os.path.join(tree, str(seed), "results", dataset, model,
                                                f"{metric}_{split}.csv")
                            require(os.path.exists(path), f"the main wrote no {path}")
                            with open(path) as f:
                                cell = f.read().splitlines()[1].split(",")[1]
                            values[(main_name, split, dataset, model, metric, seed)] = \
                                math.nan if cell == "" else float(cell)
        for seed in SEEDS16:
            mse = values[("regression", "test", SETS16["regression"], "pls-onb", "mse", seed)]
            acc = values[("classification", "test", SETS16["classification"], "pls-onb", "acc",
                          seed)]
            require(mse < MSE_MAX15, f"seed {seed}: pls-onb test MSE {mse} >= {MSE_MAX15}")
            require(acc > ACCURACY_MIN15["wine_uci"],
                    f"seed {seed}: pls-onb test accuracy {acc} <= {ACCURACY_MIN15['wine_uci']}")
            require(all(math.isfinite(v) for k, v in values.items() if k[-1] == seed),
                    f"seed {seed}: a metric is not finite")

        # (b) aggregate_seeds: every (dataset, model, metric) over the three seeds
        for main_name in SETS16:
            long = aggregate_seeds.collect(cards["tree"](tmp, main_name), "test")
            cells = aggregate_seeds.grouped(long, ("dataset", "model", "metric"))
            require({(SETS16[main_name], m, k) for m in MODELS16 for k in METRICS16[main_name]}
                    <= set(cells) and all(len(v) == len(SEEDS16) for v in cells.values()),
                    f"{main_name}: cells {[(k, len(v)) for k, v in cells.items()]}")
            log(f"  (b) {main_name}: {len(cells)} (dataset, model, metric) cells, n = "
                f"{len(SEEDS16)} each\n" + aggregate_seeds.render(long, ["nll"]))

        # (c) make_results_summary over the root
        out = os.path.join(tmp, "summary", "RESULTS.md")
        text = make_results_summary.main(["--root", tmp, "--out", out, "--provenance",
                                          f"{smi}, chip_smoke.py phase 16"])
        sections = text.split("\n## ")
        for task, dataset in SETS16.items():
            head = [s for s in sections if s.startswith(
                f"PLS vs SVGP head-to-head (headline {task} protocol, test split)")]
            require(len(head) == 1 and f"| {dataset} |" in head[0],
                    f"the {task} head-to-head names no {dataset}")
        rollup = make_results_summary.real_data_rollup_section(tmp)
        require(rollup and rollup in text and all(
            f"| {d} |" in rollup for d in SETS16.values()), "the rollup names both sets")
        long_csv = os.path.join(tmp, "summary", "uci_metrics_long.csv")
        rows = aggregate_seeds.read_metrics_long(long_csv)
        require(len(rows) >= len(values), f"the long CSV holds {len(rows)} rows")
        exact = 0
        for task, _, split, dataset, model, metric, seed, value in rows:
            key = (task, split, dataset, model, metric, seed)
            if key in values:
                require(value == values[key] or (math.isnan(value) and math.isnan(values[key])),
                        f"long CSV {key}: {value!r} against the per-seed file's "
                        f"{values[key]!r}")
                exact += 1
        require(exact == len(values), f"{exact} of {len(values)} per-seed values in the long CSV")
        empty = os.path.join(tmp, "empty")
        require(make_results_summary.real_data_rollup_section(empty, long_csv) == rollup,
                "the rollup from the long CSV alone differs from the tree's")
        for task in SETS16:
            require(aggregate_seeds.render(aggregate_seeds.collect(
                os.path.join(empty, "uci", task, cards["MAINS"][task]["protocol"]), "test",
                long_csv)) == aggregate_seeds.render(aggregate_seeds.collect(
                    cards["tree"](tmp, task), "test")),
                f"{task}: the tables from the long CSV alone differ from the tree's")
        log(f"  (c) the summary ({len(text.splitlines())} lines) names both sets; the long CSV "
            f"gives back all {exact} per-seed values exactly; the rollup and both tables "
            "render the same from the long CSV alone\n" + rollup)
        log(f"  phase 16's mains: {seconds:.1f} s; launches {launches}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 17: slice 10, the graphed training runs against their eager form
# --------------------------------------------------------------------------
def phase_graph_runs(smoothed):
    """The training runs that loop over steps on the host through
    ``scripts/graph_runs.py``, at the UCI mains' shapes, fp64: each graphed
    run (one step captured into a CUDA graph, replayed in chunks) against
    the eager runner on the same inputs and generator, bit for bit, with its
    ms a step, host syncs and launch calls both ways; and B2 with its
    outputscale read on the device against the same gram from a host value.
    The exact GP, the Dirichlet GP, the SVGP and the two ``off`` tiers; a
    run that stops inside a chunk and one that stops on a NaN. Returns Q1's
    launches (``smoothed``, the smoothed-Bernoulli ``off`` tier's)."""
    from projected_langevin_sampling_torch.ops.cuda.gram import ard_gram_scaled
    from projected_langevin_sampling_torch.utils import early_stopper

    x = torch.randn(517, 8, dtype=torch.float64, device="cuda")
    scale = torch.tensor(1.37, dtype=torch.float64, device="cuda")
    same = ard_gram_scaled(x, x, scale, same=True)
    require(torch.equal(same, ard_gram_scaled(x, x, 1.37, same=True))
            and torch.equal(ard_gram_scaled(x, x[:300], scale),
                            ard_gram_scaled(x, x[:300], 1.37)),
            "B2 with its outputscale on the device differs from the host value's gram")
    log("  B2 with the outputscale read on the device: bit for bit the host value's gram")
    runs = runpy.run_path(os.path.join(ROOT, "scripts", "graph_runs.py"))
    smoothed.launches = 0
    results = runs["hold_all"]("cuda", log=log)
    torch.cuda.synchronize()
    launches = smoothed.launches
    log(f"  Q1 launches over the runs: {launches}")
    require(launches >= 1, "the smoothed-Bernoulli off tier did not launch Q1")
    chunk = early_stopper.CHECK_EVERY
    for r in results:
        g, e = r["graph"], r["eager"]
        require(r["bitwise"], f"{r['name']}: the graphed run differs from its eager form")
        require(g["mode"] == "graph" and g["captures"] >= 1 and e["mode"] == "eager",
                f"{r['name']}: forms {g['mode']} ({g['captures']} captures), {e['mode']}")
        require(g["host_syncs"] == e["host_syncs"] == -(-g["steps_launched"] // chunk),
                f"{r['name']}: {g['host_syncs']} host syncs for {g['steps_launched']} steps")
        require(r["counters_agree"], f"{r['name']}: B2 counted {g['counters']} graphed, "
                f"{e['counters']} eager")
        require(g["launches"] is None or e["launches"] is None or g["launches"] < e["launches"],
                f"{r['name']}: {g['launches']} launch calls graphed, {e['launches']} eager")
    by_name = {r["name"]: r for r in results}
    stop = by_name["stop inside a chunk"]["graph"]
    # it stops at epoch `recorded` (that epoch's loss is not recorded): not a
    # chunk's last epoch, and before the run's end
    require(0 < stop["recorded"] and stop["recorded"] % chunk != chunk - 1
            and stop["steps_launched"] < by_name["stop inside a chunk"]["steps"],
            f"the stopping run recorded {stop['recorded']} epochs in {stop['steps_launched']}")
    nan = by_name["stop on a NaN"]["graph"]
    require(nan["recorded"] < by_name["stop on a NaN"]["steps"], "the NaN run did not stop")
    return launches


# --------------------------------------------------------------------------
# phase 18: slice 11, the preconditioned mixture main against its CPU spread
# --------------------------------------------------------------------------
# The mixture main at config_precond.yaml cut in depth (GP epochs only,
# experiments_torch/curves/mixture_likelihood/config_precond_short.yaml) on
# curve 1, PLS seed 0, fp64, through scripts/curve_mains.py's
# run_mixture_precond (the split and shift of the particles' train
# predictions, without predictive noise). The card draws its own Langevin
# noise, so it is held to the spread of the port's CPU runs of the same data
# draw over PLS seeds 0-9 (python3 scripts/curve_mains.py --device cpu
# --curves 1 --mixture_bands 0-9, on the CPU of the development machine;
# the port's main equals the JAX package's on carried draws,
# scripts/carried_gaps.py): 30-31 of 50 particles in the shifted mode,
# estimated shift 18.2591-18.4790, NLL a train point 4.17880-4.19000. The
# bands are those ranges widened on each side by three times their width,
# and by three particles for the split. The card's own ten seeds gave
# 30-31, 18.2613-18.5465 and 4.16279-4.20350; its seed 0, its draws
# replayed on the CPU, gives the card's particles to 1e-14. The same CPU
# runs in fp32 (--dtype float32) give 31, 18.3308-18.4366 and
# 4.25381-4.29625: the split and shift bands hold them, the NLL band
# (upper end 4.2236) fails every one of them.
CURVE18 = 1
SPLIT18 = (27, 34)  # particles in the shifted mode
SHIFT18 = (18.2591 - 3 * 0.2199, 18.4790 + 3 * 0.2199)
NLL18 = (4.17880 - 3 * 0.01120, 4.19000 + 3 * 0.01120)


def phase_mixture_precond(counters):
    """The mixture main on ``config_precond_short.yaml``, curve 1, on the
    card: its mode split, estimated shift and NLL within the CPU spread
    (constants above), its particles finite, its GP fit, build and predict
    on B2."""
    import tempfile

    from projected_langevin_sampling_torch.ops.cuda.gram import ARDGram

    curves = runpy.run_path(os.path.join(ROOT, "scripts", "curve_mains.py"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mixture_")
    try:
        ARDGram.backward_calls = 0
        out, seconds, launches = run_counted(counters, lambda: curves["run_mixture_precond"](
            tmp, "cuda", CURVE18, 0))
        launches["backward"] = ARDGram.backward_calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  curve {CURVE18}: {seconds:.1f} s; launches {launches}; particles in the curve mode "
        f"{out['n_lower']}, in the shifted mode {out['n_upper']} (band {SPLIT18}), estimated "
        f"shift {out['est_shift']:.4f} (band {SHIFT18[0]:.4f}-{SHIFT18[1]:.4f}), NLL "
        f"{out['nll']:.5f} (band {NLL18[0]:.5f}-{NLL18[1]:.5f})")
    require(out["finite"], "the mixture main's particles are not finite")
    require(SPLIT18[0] <= out["n_upper"] <= SPLIT18[1],
            f"{out['n_upper']} particles in the shifted mode, outside {SPLIT18}")
    require(SHIFT18[0] <= out["est_shift"] <= SHIFT18[1],
            f"estimated shift {out['est_shift']} outside {SHIFT18}")
    require(NLL18[0] <= out["nll"] <= NLL18[1], f"NLL {out['nll']} outside {NLL18}")
    require(launches["gram"] >= 1 and launches["backward"] >= 1,
            f"mixture main: B2 {launches['gram']}, B2 backward {launches['backward']}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    import projected_langevin_sampling_torch as pt
    from projected_langevin_sampling_torch.ops.cuda import build
    from projected_langevin_sampling_torch.ops.cuda import gram, spectral_train as spec
    from projected_langevin_sampling_torch.utils.backend import ensure_live_backend

    # a GPU driver that hangs CUDA's initialisation hangs a child, not this run
    script_start = t0 = time.perf_counter()
    ensure_live_backend(120.0, context="chip_smoke")
    log(f"backend probe: CUDA initialises in a subprocess ({time.perf_counter() - t0:.1f} s)")
    from projected_langevin_sampling_torch.ops.cuda import general_train as gen
    from projected_langevin_sampling_torch.ops.cuda import quadratic_train as quad
    from projected_langevin_sampling_torch.ops.cuda import fused_update as fused
    from projected_langevin_sampling_torch.ops.cuda import smoothed_bernoulli as sbk
    from projected_langevin_sampling_torch.ops.cuda import tc_product as tc

    # phase 1: environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"phase 1: card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    start = t0 = time.perf_counter()
    logs = build.build()
    log(f"  {len(logs)} kernels built in {time.perf_counter() - t0:.1f} s (all nvcc in parallel)")
    for name in build.SOURCES:  # the -Xptxas -v report, kept beside each library
        with open(build.library_path(name) + ".log") as f:
            out = f.read()
        for line in out.splitlines():
            # B1's and B4's kernels by name: their registers, spills and shared memory
            if ("registers" in line or "spill" in line
                    or (name in ("quadratic_train", "spectral_train") and "entry function" in line)):
                log(f"  {name}: {line.strip()}")
    for name in ("general_train", "quadratic_train", "fused_update"):
        text = sass_text(build.library_path(name))
        hmma = None if text is None else text.count("HMMA") + text.count("HGMMA")
        log(f"  {name}: " + ("HMMA/HGMMA not measured (no cuobjdump)" if hmma is None
                              else f"{hmma} HMMA and HGMMA instructions in its SASS"))
        require(hmma is None or hmma > 0, f"{name} holds no tensor-core instruction")
    b1_mixes = b1_step_mixes(build.library_path("spectral_train"))
    for kernel, mix in (b1_mixes or {}).items():
        require(mix is not None, f"no step loop found in {kernel}'s SASS")
        log(f"  spectral_train {kernel}: step loop, SASS instructions a step per thread: "
            f"{mix_text(mix)}")
    if b1_mixes is None:
        log("  spectral_train: step-loop op mix not measured (no cuobjdump)")
    log(f"  tensor-core product (csrc/tc_product.cuh): {tc.TILE_M} x {tc.TILE_N} tiles, stages of "
        f"{tc.TILE_K}; at the headline B5's matrix-prior update splits its depth into "
        f"{tc.split_k(M, J, -(-N // tc.TILE_K) * tc.TILE_K + M).slices} slices over "
        f"{tc.split_k(M, J, N).tiles} output tiles; B3's wgmma update (csrc/general_train.cu) "
        f"{gen.update_plan(N, M, J)}")

    def phase(title, fn, *args):
        log(title)
        t = time.perf_counter()
        out = fn(*args)
        log(f"  ({time.perf_counter() - t:.1f} s; {time.perf_counter() - start:.1f} s so far)")
        return out

    gram_res = phase("phase 2: B2 gram against its plain version", phase_gram, gram)
    spec_res = phase("phase 3: B1 spectral trainer against its plain version and its law",
                     phase_spectral, spec, b1_mixes)
    launches = phase(f"phase 4: main path, N={N}, M={M}, J={J}, fp32, {STEPS} steps",
                     phase_main_path, pt, gram, spec)

    def demo():
        rmse = runpy.run_path(os.path.join(ROOT, "examples", "readme_demo_torch.py"))["main"]()
        require(rmse < 0.35, f"README demo RMSE {rmse}")

    phase("phase 5: README demo in fp64 on the card", demo)
    gen_res = phase("phase 6: B3 general-cost trainer against its plain version and its law",
                    phase_general, pt, gen)
    launches_7, classifier = phase(f"phase 7: slice 2 main path, smoothed Bernoulli classification, N={N}, "
                       f"M={M}, J={J}, fp32, {STEPS7} steps",
                       phase_classification, pt, gram, spec, gen)
    quad_res = phase("phase 8: B4 quadratic trainer against its plain version and its law",
                     phase_quadratic, pt, quad, tc)
    fused_res = phase("phase 9: B5 fused update against its plain version", phase_fused, pt,
                      fused)
    q1_res = phase(f"phase 9b: Q1 smoothed-Bernoulli quadrature against its plain version, "
                   f"{N9B} x {J9B}, Q = {Q9B}", phase_smoothed, sbk, build)
    counters = {"gram": gram.ard_gram_scaled, "spectral": spec.spectral_train,
                "general": gen.general_train, "quadratic": quad.quadratic_train,
                "fused": fused.fused_update, "smoothed": sbk.smoothed_bernoulli}
    launches_10 = phase(f"phase 10: slice 3 main path, the inducing-point basis, N={N}, M={M}, "
                        f"J={J}, fp32", phase_ipb_path, pt, counters)
    launches_11 = phase(f"phase 11: slice 4 main path, the UCI regression protocol at kin8nm's "
                        f"shape (N={N11}, D={D11}, fp64)", phase_slice4, pt, gram, counters,
                        classifier)
    phase(f"phase 12: slice 5, scale-out on a 1 x 1 mesh, N={N}, M={M}, J={J}, fp32",
          phase_scale_out, pt, dict(counters, partial=fused.fused_drift),
          fused_res.pop("fused_call"), smi)
    launches_13 = phase(f"phase 13: slice 6, the UCI harness's regression main on kin8nm "
                        f"({ROWS13['kin8nm']} rows) and classification main on rice "
                        f"({ROWS13['rice']} rows), fp64, depth cut", phase_harness, counters)
    launches_14 = phase("phase 14: slice 7, the curve mains (regression, classification, Poisson "
                        "and its study, mixture and its summary) on curve 2, fp64, and the "
                        "profiler sweep, fp32, depth cut", phase_curves, counters)
    launches_15 = phase("phase 15: slice 8, the UCI mains on the real sklearn-bundled sets, the "
                        "gap attribution, the SVGP audit, the ONB scalings and the parallel "
                        "regression main on a 1 x 1 mesh, fp64, depth cut", phase_slice8, counters)
    launches_16 = phase("phase 16: slice 9, the results pipeline over the UCI mains on "
                        "diabetes_sklearn and wine_uci, data seeds 0-2, fp64, depth cut",
                        phase_results, counters, smi)
    launches_17 = phase("phase 17: slice 10, the graphed training runs (exact GP, Dirichlet GP, "
                        "SVGP, the Student-T and smoothed-Bernoulli off tiers, a stop inside a "
                        "chunk and on a NaN) against their eager form, fp64", phase_graph_runs,
                        sbk.smoothed_bernoulli)
    launches_18 = phase(f"phase 18: slice 11, the preconditioned mixture main on curve {CURVE18} "
                        "against its CPU spread over PLS seeds, fp64, depth cut",
                        phase_mixture_precond, counters)

    kernels = [
        {"name": "spectral_train", "route": "cuda",
         "source": "projected_langevin_sampling_torch/csrc/spectral_train.cu",
         "replaces": "projected_langevin_sampling_tpu/ops/pallas/spectral_train.py:120",
         # the slice 1 path's launches and the harnesses' (phases 13-16)
         "launches": (launches["spectral"] + launches_13["spectral"] + launches_14["spectral"]
                      + launches_15["spectral"] + launches_16["spectral"]),
         "library_ms": None,
         "matched": True, **spec_res},
        {"name": "ard_gram", "route": "cuda",
         "source": "projected_langevin_sampling_torch/csrc/gram.cu",
         "replaces": "projected_langevin_sampling_tpu/ops/pallas/gram.py:42",
         # the slice 1 path's launches, the slice 4 path's (phase 11) and the
         # harnesses' (phases 13-16, 18)
         "launches": (launches["gram"] + launches_11["gram"] + launches_13["gram"]
                      + launches_14["gram"] + launches_15["gram"] + launches_16["gram"]
                      + launches_18["gram"]),
         "library_ms": None, "matched": True, **gram_res,
         **b2_backward_keys(launches_11, launches_13["backward"] + launches_14["backward"]
                            + launches_15["backward"] + launches_16["backward"]
                            + launches_18["backward"])},
        {"name": "general_train", "route": "cuda",
         "source": "projected_langevin_sampling_torch/csrc/general_train.cu",
         "replaces": "projected_langevin_sampling_tpu/ops/pallas/general_train.py:307",
         "launches": launches_7["general"], "library_ms": None, "matched": True, **gen_res},
        {"name": "quadratic_train", "route": "cuda",
         "source": "projected_langevin_sampling_torch/csrc/quadratic_train.cu",
         "replaces": "projected_langevin_sampling_tpu/ops/pallas/quadratic_train.py:123",
         "launches": launches_10["quadratic_fused"]["quadratic"], "library_ms": None,
         "matched": True, **quad_res},
        {"name": "fused_update", "route": "cuda",
         "source": "projected_langevin_sampling_torch/csrc/fused_update.cu",
         "replaces": "projected_langevin_sampling_tpu/ops/pallas/fused_update.py:134",
         "launches": launches_10["langevin_steps"]["fused"], "library_ms": None,
         "matched": True, **fused_res},
        {"name": "smoothed_bernoulli", "route": "cuda",
         "source": "projected_langevin_sampling_torch/csrc/smoothed_bernoulli.cu",
         "replaces": None,  # port only: the JAX package's off tier runs it as XLA code
         # the smoothed cost's off tier in the harnesses (phases 13-16) and
         # the graphed runs (phase 17)
         "launches": (launches_13["smoothed"] + launches_14["smoothed"] + launches_15["smoothed"]
                      + launches_16["smoothed"] + launches_17),
         "library_ms": None, "matched": True, **q1_res},
    ]
    key_order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms", "matched",
                 "backward_launches", "backward_ms", "backward_plain_ms"]
    log(f"all phases passed in {time.perf_counter() - start:.1f} s (the build included); the "
        f"whole script {time.perf_counter() - script_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{k: kern[k] for k in key_order if k in kern}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
