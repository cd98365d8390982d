"""The card: presence check and identity.

Nothing in the port picks a device for the caller.  Code that must run
on the card calls :func:`require_cuda` and fails when there is none;
it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def require_cuda(index: int = 0) -> torch.device:
    """CUDA device ``index`` (the first by default: a rank of the sharded
    steps asks for its own); raises when PyTorch sees no card, or fewer
    than ``index + 1``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (this path runs on the card only)")
    n = torch.cuda.device_count()
    if not 0 <= index < n:
        raise RuntimeError(f"no CUDA device {index}: PyTorch sees {n}")
    return torch.device("cuda", index)


def card_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them
    (``NVIDIA H100 80GB HBM3, 700.00 W``); one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def to_host(x):
    """Tensors to numpy arrays, as ``jax.device_get`` fetches: a tensor
    (on any device) becomes an array, a tuple or list of them a tuple of
    arrays; arrays and None pass through."""
    if x is None or isinstance(x, np.ndarray):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(to_host(v) for v in x)
    return x.cpu().numpy()
