"""The benchmark of the PyTorch/CUDA port: one cell of ``BENCHMARK.json`` on
the card this process runs on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, builds the program's kernels
(into ``build/`` of the checkout) and runs one whole call as a warm-up.
The window then makes calls back to back until ``--seconds`` have passed and
the last call has ended; each end-to-end metric is over all the work and all
the time of the window. With ``--trace 1`` the window runs under the torch
profiler, for at most ``TRACE_SECONDS``, and the line carries the cell's
per-layer metrics instead. After the
window a sample of the calls, drawn from the seed, is held to the plain
reference (``benchmark/reference/``), each number beside its limit
(``benchmark/limits/<cell>.json``). The last line of standard output is the
result as one JSON object.

Everything a cell needs is found by name: the configuration in
``configs/<config>.json``, the traffic in ``traffic/<traffic>.json``, whose
``entry`` names the module that drives it, ``entries/<entry>.py``, the limits in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's work is launches and small
# factorisations, and idle worker threads only contend for the cores of a
# host the card's machine may share
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "projected_langevin_sampling_tpu")
# a traced window's length at most: the profiler keeps every kernel of the
# window (hundreds of thousands a second in a graphed fit), and reading them
# back has to end well inside a run's time limit
TRACE_SECONDS = 5.0


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


class Spec:
    """One cell of ``BENCHMARK.json``, resolved by name."""

    def __init__(self, benchmark: dict, workload: str):
        cells = {w["name"]: w for w in benchmark["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        self.chips = int(self.cell["chips"])
        self.config = read_json("configs", f"{self.cell['config']}.json")
        self.traffic = read_json("traffic", f"{self.cell['traffic']}.json")
        self.limits = read_json("limits", f"{workload}.json")
        self.entry_path = os.path.join(HERE, "entries", f"{self.traffic['entry']}.py")
        applies = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
        self.end_to_end = [m for m in benchmark["end_to_end"] if applies(m)]
        self.per_layer = [m for m in benchmark["per_layer"] if applies(m)]

    def entry(self):
        return load_module(self.entry_path, f"benchmark_entry_{self.traffic['entry']}")

    def reader(self, metric: str):
        return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                           f"benchmark_metric_{metric.replace('.', '_')}")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules, each taken whole, that are JAX or
    the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def sample_calls(seed: int, attempted: int, count: int) -> list[int]:
    """The calls held to the reference, drawn from the seed."""
    return sorted(random.Random(seed * 7919 + 17).sample(range(attempted), min(count, attempted)))


def run_window(cell, seconds: float, trace: bool, sync):
    """Calls back to back until ``seconds`` have passed and the last call
    has ended; returns ``(window_s, work per call, failed, profiler or
    None)``. ``sync`` waits for the device."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness.timing import SPAN

    works, seconds_per_call, failed = [], [], 0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace else None
    if prof is not None:
        prof.__enter__()
    sync()
    start = time.perf_counter()
    try:
        i = 0
        while True:
            called = time.perf_counter()
            with record_function(SPAN):
                try:
                    work = cell.call(i)
                except Exception as exc:  # a call that raises is a failed answer
                    print(f"call {i} raised {type(exc).__name__}: {exc}", file=sys.stderr)
                    cell.answers[i] = None
                    work = 0.0
                sync()
            failed += work == 0.0
            works.append(work)
            seconds_per_call.append(time.perf_counter() - called)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    ordered = sorted(seconds_per_call)
    print(f"calls: {len(ordered)}, seconds a call: min {ordered[0]:.4f}, median "
          f"{ordered[len(ordered) // 2]:.4f}, max {ordered[-1]:.4f}", file=sys.stderr)
    return window_s, works, failed, prof


def checks(spec: Spec, cell, seed: int, attempted: int) -> dict:
    """Each compared number, the worst over the sampled calls, beside its
    limit."""
    worst: dict[str, float] = {}
    for i in sample_calls(seed, attempted, int(spec.traffic["check_calls"])):
        truth = cell.reference(i)
        for name, value in cell.compare(i, cell.answers.get(i), truth).items():
            worst[name] = max(worst.get(name, 0.0), value if value == value else math.inf)
    return {name: {"value": worst.get(name, math.inf), "limit": limit}
            for name, limit in spec.limits.items()}


def measure(spec: Spec, entry, cell, seed: int, seconds: float, trace: bool, setup_s: float,
            sync, device_info) -> dict:
    """The window, its metrics and the check of its answers: the result
    line as a dict. ``device_info()`` reads the device's record after the
    window."""
    window_s, works, failed, prof = run_window(
        cell, min(seconds, TRACE_SECONDS) if trace else seconds, trace, sync)
    attempted, work = len(works), sum(works)
    device = device_info()
    metrics, breakdown = {}, None
    if trace:
        from benchmark.harness.timing import Trace

        traced = Trace.from_profiler(prof, works)
        del prof
        device.update({"busy_s": traced.busy_s, "window_s": traced.window_s})
        for m in spec.per_layer:
            value = spec.reader(m["name"]).read(traced, cell.shapes)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": traced.top_device_ops(), "idle_gaps": traced.idle_gaps()}
    else:
        for m in spec.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == entry.END_TO_END:
                value = entry.end_to_end(window_s, work) if work > 0 else None
            else:
                raise KeyError(f"{m['name']} is no end-to-end metric of {spec.traffic['entry']}")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.release()
    compared = checks(spec, cell, seed, attempted)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": attempted, "failed": int(failed),
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window_s"] = window_s
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = Spec(json.load(f), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {spec.chips} CUDA device(s); this machine shows {have}",
              file=sys.stderr)
        return 3
    # the program's kernels build into build/cuda of this checkout; any other
    # kernel cache stays inside it too
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    torch.zeros(1, device=device)
    at_card = time.perf_counter()
    entry = spec.entry()
    cell = entry.Cell(spec.config, spec.traffic, args.seed, device)
    torch.cuda.synchronize()
    at_model = time.perf_counter()
    cell.call(-1)  # the warm-up: every shape of the window, built and captured once
    torch.cuda.synchronize()
    at_warm = time.perf_counter()
    setup_s = at_warm - T0
    print(f"set-up: torch and the card {at_card - T0:.3f} s, inputs and model "
          f"{at_model - at_card:.3f} s, warm-up call {at_warm - at_model:.3f} s", file=sys.stderr)

    def device_info() -> dict:
        peak = max(torch.cuda.max_memory_allocated(d) for d in range(spec.chips))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec.chips,
                "memory_peak_bytes": int(peak)}

    result = measure(spec, entry, cell, args.seed, args.seconds, bool(args.trace), setup_s,
                     torch.cuda.synchronize, device_info)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    card = power_limit()
    compared = result.pop("checks")
    result["card"] = card
    result["checks"] = compared  # last in the line
    print(f"card: {card}; window {result['window_s']:.3f} s, {result['attempted']} calls, "
          f"{result['failed']} failed", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
