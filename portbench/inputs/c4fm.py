"""What the C4FM generators share: the frozen test vector, the draw of
a block's keyed channels from a traffic file, the modulator and the
noise.

The modulator is a plain-torch copy of the port's
``protocol/p25/encode.py`` (``c4fm_clean``, ``c4fm_iq``,
``vector_stream``) at commit 1acf1f855b4962341c6932295300c03c25b32489,
rewritten to run batched on the card; the test vector is a frozen copy
in ``portbench/data/p25p1_tables.npz`` (its ``tv_`` arrays).  A later
change to the port's encoders cannot move them.

A traffic file (``portbench/traffic/<mix>.json``) says:

- ``ring``: how many distinct blocks the run cycles through;
- ``keyed``: which channels carry a call in a block, ``{"all": true}``
  or ``{"all_but": [channels]}``;
- ``lead_dibits``: the range ``[lo, hi]`` of filler dibits each keyed
  channel sends before the call (drawn per channel and block).

A channel that carries no call carries the same white noise and no
signal.  The configuration gives the channel count, the rates and the
SNR.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

LEVELS = (1.0, 3.0, -1.0, -3.0)
CHUNK = 64                    # channels modulated at once
DATA_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "p25p1_tables.npz")


def test_vector(path: str = DATA_NPZ) -> dict[str, np.ndarray]:
    """The frozen test vector: ``body``, ``lead``, ``tail``,
    ``ldu_starts``, ``bits88`` (the ``tv_`` arrays)."""
    with np.load(path) as z:
        return {k[3:]: z[k] for k in z.files if k.startswith("tv_")}


@dataclass
class BlockInfo:
    """What the generator put in one block of the ring."""
    keyed: np.ndarray         # [K] channel (or bin) indices with a call
    leads: np.ndarray         # [K] filler dibits before each call


def draw(cfg: dict, mix: dict, seed: int, block: int,
         n_channels: int) -> BlockInfo:
    """The keyed channels and their leads of ring block ``block``."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), int(block), 1])
    keyed = mix["keyed"]
    if keyed.get("all"):
        sel = np.arange(n_channels)
    elif "all_but" in keyed:
        sel = np.setdiff1d(np.arange(n_channels), keyed["all_but"])
    else:
        raise ValueError(f"unknown keyed set {keyed!r}")
    lo, hi = mix["lead_dibits"]
    leads = rng.integers(lo, hi + 1, sel.size)
    return BlockInfo(sel.astype(np.int64), leads.astype(np.int64))


def vector_stream(tv: dict, lead: int, n_dibits: int) -> np.ndarray:
    """One channel's dibits: the last ``lead`` filler dibits, the 16 LDUs
    of the test vector and its tail filler, cut to ``n_dibits``."""
    if not 0 <= lead <= len(tv["lead"]):
        raise ValueError(f"lead must be in [0, {len(tv['lead'])}]")
    s = np.concatenate([tv["lead"][len(tv["lead"]) - lead:], tv["body"],
                        tv["tail"]])
    if len(s) < n_dibits:
        raise ValueError(f"the vector holds {len(s)} dibits after this "
                         f"lead, fewer than {n_dibits}")
    return s[:n_dibits]


def c4fm_clean(dibits: torch.Tensor, sps: int, fs: float,
               dev_hz: float) -> torch.Tensor:
    """``[K, n]`` dibits → ``[K, n·sps]`` complex128 C4FM: levels ±1/±3
    of ``dev_hz / 3`` Hz, a moving average over half a symbol ('same'
    alignment), the phase summed in float64."""
    lv = torch.tensor(LEVELS, dtype=torch.float64,
                      device=dibits.device)[dibits.long()]
    inst = torch.repeat_interleave(lv, sps, dim=1) * (dev_hz / 3.0)
    k = max(sps // 2, 1)
    w = torch.full((1, 1, k), 1.0 / k, dtype=torch.float64,
                   device=dibits.device)
    left = (k - 1) // 2 if k % 2 else k // 2
    inst = torch.nn.functional.conv1d(
        torch.nn.functional.pad(inst[:, None], (left, k - 1 - left)), w
    )[:, 0]
    return torch.polar(torch.ones_like(inst),
                       torch.cumsum(inst, dim=1) * (2 * math.pi / fs))


def noise(gen: torch.Generator, shape, snr_db: float, device
           ) -> torch.Tensor:
    """White complex noise, each plane of standard deviation
    10^(−snr/20), as ``[..., 2]`` float32 planes."""
    return torch.randn((*shape, 2), generator=gen, dtype=torch.float32,
                       device=device) * float(10 ** (-snr_db / 20))


def generator(seed: int, block: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.default_rng(
        [int(seed) & (2 ** 64 - 1), int(block), 2]).integers(2 ** 62)))
    return g


def hold(x: torch.Tensor, pin: bool) -> torch.Tensor:
    """A block made on the card, held on the host (pinned where ``pin``)
    as an SDR's ingest ring holds it."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
    host.copy_(x)
    return host
