"""The card: presence check and identity.

Nothing in the port picks a device for the caller.  Code that must run
on the card calls :func:`require_cuda` and fails when there is none;
it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (this path runs on the card only)")
    return torch.device("cuda", 0)


def card_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them
    (``NVIDIA H100 80GB HBM3, 700.00 W``); one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
