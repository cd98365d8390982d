"""Generator of wideband bands: a ring of ``[n, 2]`` float32 I/Q bands at
the configuration's ``band_fs``, each bin a 48 kHz P25 C4FM baseband
(the test vector's call where keyed, and the noise), made on the card
from the seed and held on the host.  The band placer is a plain-torch
copy of the port's ``engine/fleetvec.py`` (``place``) at commit
1acf1f855b4962341c6932295300c03c25b32489."""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs.c4fm import (CHUNK, BlockInfo, c4fm_clean, draw,
                                   generator, hold, noise, test_vector,
                                   vector_stream)


def band_block(cfg: dict, tv: dict, info: BlockInfo, seed: int,
               block: int, device) -> torch.Tensor:
    """``[n, 2]`` float32 planes of a band at ``band_fs``: each bin's
    48 kHz baseband (the vector where keyed, and the noise) raised into
    its bins of one FFT of the whole band (an exact periodic
    interpolation for whole-Hz offsets over whole seconds)."""
    n_ch, fs48 = cfg["channels"], cfg["fs"]
    fs = cfg["band_fs"]
    n = int(round(fs * cfg["block_s"]))
    n48 = int(round(n * fs48 / fs))
    secs = n / fs
    j = torch.arange(n48, device=device)
    j = torch.where(j < (n48 + 1) // 2, j, j - n48)
    kk = np.arange(n_ch)
    offs = np.where(kk <= n_ch // 2, kk, kk - n_ch) * (fs / n_ch)
    keyed = {int(k): int(lead) for k, lead in zip(info.keyed, info.leads)}
    gen = generator(seed, block, device)
    spec = torch.zeros(n, dtype=torch.complex128, device=device)
    sps = cfg["sps"]
    n_dib = n48 // sps
    for s in range(0, n_ch, CHUNK):
        bins = list(range(s, min(s + CHUNK, n_ch)))
        x = torch.view_as_complex(noise(gen, (len(bins), n48),
                                        cfg["snr_db"], device)
                                  ).to(torch.complex128)
        on = [i for i, k in enumerate(bins) if k in keyed]
        if on:
            dib = np.stack([vector_stream(tv, keyed[bins[i]], n_dib)
                            for i in on])
            sig = c4fm_clean(torch.as_tensor(dib, device=device), sps, fs48,
                             cfg["dev_hz"])
            rows = torch.as_tensor(on, device=device)
            x[rows, :n_dib * sps] += sig
        spec_x = torch.fft.fft(x, dim=1)
        for i, k in enumerate(bins):
            shift = offs[k] * secs
            if abs(shift - round(shift)) > 1e-9:
                raise ValueError(f"bin offset {offs[k]} Hz is not a whole "
                                 "FFT bin")
            spec[torch.remainder(j + int(round(shift)), n)] += spec_x[i]
    band = torch.fft.ifft(spec) * (n / n48)
    return torch.view_as_real(band.to(torch.complex64)).contiguous()


def make_ring(cfg: dict, mix: dict, seed: int, device, pin: bool
              ) -> tuple[list[torch.Tensor], list[BlockInfo]]:
    """The ring of distinct bands and what each holds."""
    tv = test_vector()
    ring, infos = [], []
    for b in range(int(mix["ring"])):
        info = draw(cfg, mix, seed, b, cfg["channels"])
        ring.append(hold(band_block(cfg, tv, info, seed, b, device), pin))
        infos.append(info)
    return ring, infos
