"""Generator of per-channel P25 C4FM basebands: a ring of ``[C, B, 2]``
float32 I/Q blocks at the configuration's ``fs``, made on the card from
the seed and held on the host.  Each keyed channel carries the test
vector's call after its lead; every channel carries the noise."""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs.c4fm import (CHUNK, BlockInfo, c4fm_clean, draw,
                                   generator, hold, noise, test_vector,
                                   vector_stream)


def channel_block(cfg: dict, tv: dict, info: BlockInfo, seed: int,
                  block: int, device, n_samples: int) -> torch.Tensor:
    """``[C, n_samples, 2]`` float32 I/Q planes on ``device``: the keyed
    channels carry the vector after their lead, every channel the
    noise."""
    C, sps = cfg["channels"], cfg["sps"]
    out = noise(generator(seed, block, device), (C, n_samples),
                cfg["snr_db"], device)
    n_dib = n_samples // sps
    for s in range(0, info.keyed.size, CHUNK):
        ks = info.keyed[s:s + CHUNK]
        dib = np.stack([vector_stream(tv, int(lead), n_dib)
                        for lead in info.leads[s:s + CHUNK]])
        x = c4fm_clean(torch.as_tensor(dib, device=device), sps,
                       cfg["fs"], cfg["dev_hz"])
        idx = torch.as_tensor(ks, device=device)
        out[idx, :n_dib * sps] += torch.view_as_real(x.to(torch.complex64))
    return out


def make_ring(cfg: dict, mix: dict, seed: int, device, pin: bool
              ) -> tuple[list[torch.Tensor], list[BlockInfo]]:
    """The ring of distinct blocks and what each holds."""
    tv = test_vector()
    n = int(round(cfg["fs"] * cfg["block_s"]))
    ring, infos = [], []
    for b in range(int(mix["ring"])):
        info = draw(cfg, mix, seed, b, cfg["channels"])
        ring.append(hold(channel_block(cfg, tv, info, seed, b, device, n),
                         pin))
        infos.append(info)
    return ring, infos
