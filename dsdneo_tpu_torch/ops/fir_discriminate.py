"""Kernel K1: fused channel FIR + FM discriminator.

Counterpart of ``dsdneo_tpu/ops/pallas_frontend.py`` (the repo's one
Pallas kernel).  On a CUDA tensor :func:`fir_discriminate` launches
``csrc/fir_disc.cu``; on a CPU tensor it runs the plain version,
``fm_discriminate(fir_complex(x, taps))``.  There is no fallback from
the kernel to the plain version.
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch import kernels
from dsdneo_tpu_torch.dsp.frontend import fir_complex, fm_discriminate

MAX_TAPS = 255


def fir_discriminate_plain(xr: torch.Tensor, xi: torch.Tensor,
                           taps: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``[C, B]`` I/Q planes → ``[C, B]``."""
    return fm_discriminate(fir_complex(torch.complex(xr, xi), taps))


def fir_discriminate(xr: torch.Tensor, xi: torch.Tensor,
                     taps: torch.Tensor) -> torch.Tensor:
    """Fused FIR + discriminator: ``[C, B]`` float32 I/Q planes and
    ``[T]`` float32 taps (T ≤ 255) → discriminator ``[C, B]`` float32,
    with ``out[:, 0] == 0``."""
    if xr.device.type == "cpu":
        return fir_discriminate_plain(xr, xi, taps)
    C, B = xr.shape
    kernels.require(xr, "xr", torch.float32, (C, B))
    kernels.require(xi, "xi", torch.float32, (C, B))
    kernels.require(taps, "taps", torch.float32)
    if taps.dim() != 1 or not 1 <= taps.shape[0] <= MAX_TAPS:
        raise ValueError(f"taps: expected 1..{MAX_TAPS} taps, "
                         f"got shape {tuple(taps.shape)}")
    if taps.device != xr.device or xi.device != xr.device:
        raise ValueError("xr, xi and taps must be on one device")
    lib = kernels.load()
    out = torch.empty((C, B), dtype=torch.float32, device=xr.device)
    err = lib.dsd_fir_disc(xr.data_ptr(), xi.data_ptr(), taps.data_ptr(),
                           taps.shape[0], out.data_ptr(), C, B,
                           kernels.stream_handle(xr))
    kernels.check(err, "fir_disc")
    fir_discriminate.launches += 1
    return out


fir_discriminate.launches = 0
