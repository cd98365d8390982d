"""The card: presence check and identity.

Nothing in the port picks a device for the caller.  Code that must run
on the card calls :func:`require_cuda` and fails when there is none;
it never falls back to the CPU.
"""

from __future__ import annotations

import functools
import subprocess

import torch

# tensors to numpy arrays as ``jax.device_get`` fetches; a tensor whose
# copy to the host was queued waits for that copy alone
from dsdneo_tpu_torch.runtime.handoff import to_host  # noqa: F401


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


@functools.lru_cache(maxsize=None)
def f32_scalar(value: float, device) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``device``, made once per
    device: a tensor made from a Python number each call is a blocking
    copy to the card.  Shared; never write to it."""
    return torch.tensor(value, dtype=torch.float32, device=device)
