"""Generator of per-channel DMR BS two-slot basebands: a ring of
``[C, B, 2]`` float32 I/Q blocks at the configuration's ``fs``, made on
the card from the seed and held on the host.

The block's layout is a plain-torch copy of the port's
``protocol/dmr/encode.vector_block`` at commit
eba076e95be0b9cb2558d566856d75cd57827eda (each keyed channel: filler
dibits, then the stream; white noise on every channel), rewritten to
run batched on the card.  The stream is the DMR test vector (both slots
keyed, 8 voice superframes a slot, 14,114 dibits), a frozen copy in
``portbench/data/dmr_tables.npz`` (its ``tv_`` arrays).  The modulator
is the P25 generators' frozen C4FM modulator (``c4fm.c4fm_clean``:
levels ±1/±3 of ``dev_hz / 3``, a moving average over half a symbol) at
the configuration's ``dev_hz``, DMR's ±1944 Hz outer deviation: the
pulse of the port's serial DMR stream (``engine/serialvec.dmr_iq``).  A
later change to the port's encoders cannot move them.

The traffic file says, as the C4FM mixes do (``c4fm.draw``): ``ring``,
``keyed`` and ``lead_dibits``, the range of filler dibits each keyed
channel sends before the stream, drawn per channel and block.  The
filler's dibits are drawn from the seed too.  A block holds a whole
number of symbols: ``sps · round(fs · block_s / sps)`` samples.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs.c4fm import (CHUNK, BlockInfo, c4fm_clean, draw,
                                   generator, hold, noise)
from portbench.reference.dmr_chain import test_vector


def n_samples(cfg: dict) -> int:
    """Samples a block: the configuration's block length rounded to a
    whole number of symbols."""
    sps = int(cfg["sps"])
    return sps * int(round(cfg["fs"] * cfg["block_s"] / sps))


def fillers(seed: int, block: int, n_channels: int,
            max_lead: int) -> np.ndarray:
    """``[C, max_lead]`` uint8 filler dibits of ring block ``block``; a
    channel with lead ``k`` sends the last ``k`` of its row."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), int(block), 3])
    return rng.integers(0, 4, (n_channels, max_lead)).astype(np.uint8)


def stream(tv: dict, fill: np.ndarray, lead: int, n_dibits: int
           ) -> np.ndarray:
    """One channel's dibits: the last ``lead`` of ``fill``, then the
    vector, cut to ``n_dibits``."""
    if not 0 <= lead <= len(fill):
        raise ValueError(f"lead must be in [0, {len(fill)}]")
    s = np.concatenate([fill[len(fill) - lead:], tv["dibits"]])
    if len(s) < n_dibits:
        raise ValueError(f"the vector holds {len(s)} dibits after this "
                         f"lead, fewer than {n_dibits}")
    return s[:n_dibits]


def channel_block(cfg: dict, tv: dict, info: BlockInfo, fill: np.ndarray,
                  seed: int, block: int, device, n: int) -> torch.Tensor:
    """``[C, n, 2]`` float32 I/Q planes on ``device``: the keyed
    channels carry the stream after their lead, every channel the
    noise."""
    C, sps = cfg["channels"], int(cfg["sps"])
    out = noise(generator(seed, block, device), (C, n), cfg["snr_db"],
                device)
    n_dib = n // sps
    for s in range(0, info.keyed.size, CHUNK):
        ks = info.keyed[s:s + CHUNK]
        dib = np.stack([stream(tv, fill[c], int(lead), n_dib)
                        for c, lead in zip(ks, info.leads[s:s + CHUNK])])
        x = c4fm_clean(torch.as_tensor(dib, device=device), sps, cfg["fs"],
                       cfg["dev_hz"])
        idx = torch.as_tensor(ks, device=device)
        out[idx, :n_dib * sps] += torch.view_as_real(x.to(torch.complex64))
    return out


def make_ring(cfg: dict, mix: dict, seed: int, device, pin: bool
              ) -> tuple[list[torch.Tensor], list[BlockInfo]]:
    """The ring of distinct blocks and what each holds."""
    tv = test_vector()
    n = n_samples(cfg)
    max_lead = int(mix["lead_dibits"][1])
    ring, infos = [], []
    for b in range(int(mix["ring"])):
        info = draw(cfg, mix, seed, b, cfg["channels"])
        fill = fillers(seed, b, cfg["channels"], max_lead)
        ring.append(hold(channel_block(cfg, tv, info, fill, seed, b, device,
                                       n), pin))
        infos.append(info)
    return ring, infos
