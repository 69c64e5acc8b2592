"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which is loaded with ``ctypes``.
Libraries go into ``build/cuda/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, the ``csrc/*.cuh`` headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. Nothing is built when a
module is imported: a kernel's first launch builds its library, and
:func:`build` builds several at once, one ``nvcc`` per source, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "cuda")
SOURCES = ("gram", "spectral_train", "general_train", "quadratic_train", "fused_update",
           "smoothed_bernoulli")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go into the build log
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME) on a machine with an sm_90a card"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen: list[str]) -> list[str]:
    """``path`` and, depth first, every header of ``csrc/`` it includes."""
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for header in _INCLUDE.findall(text):
        header_path = os.path.join(CSRC_DIR, header.decode())
        if header_path not in seen and os.path.exists(header_path):
            _sources(header_path, seen)
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(os.path.join(CSRC_DIR, f"{name}.cu"), []):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, all in parallel.

    Returns ``{name: nvcc output}`` for the sources it compiled (the
    ``-Xptxas -v`` resource report); raises with the compiler's output if any
    compile fails, after every ``nvcc`` it started has ended."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    try:
        for name in names:
            lib = library_path(name)
            if os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            started[name] = (proc, tmp, lib)
        logs, failures = {}, []
        for name, (proc, tmp, lib) in started.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
            with open(lib + ".log", "w") as f:
                f.write(out)
            logs[name] = out
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str, signatures: dict | None = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps C entry points to their ``argtypes``; they are set,
    with an ``int`` return, once, when the library is loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            for fn_name, argtypes in (signatures or {}).items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
