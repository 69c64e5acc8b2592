"""Small filesystem and CLI helpers (counterpart of ``experiments/utils.py``),
and the stage timer of the mains."""

from __future__ import annotations

import argparse
import os
import shutil
import time

import torch


def create_directory(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)


def remove_directory(directory: str) -> None:
    if os.path.exists(directory):
        shutil.rmtree(directory)


def str2bool(value: str | bool) -> bool:
    if isinstance(value, bool):
        return value
    if value.lower() in ("true", "1"):
        return True
    if value.lower() in ("false", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


class Stages:
    """Prints each stage's seconds on the host clock, after waiting for the
    device, when :meth:`done` closes it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.last = time.perf_counter()

    def done(self, what: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"  [stage] {what}: {now - self.last:.3f} s", flush=True)
        self.last = now
