"""The test bands of the trunked fleet and the wideband cell: how they
are made, and their judges.

``tools/export_torch_tables.py`` builds the dibit streams with the JAX
package's encoders and stores them in ``data/fleet_tables.npz``, after
holding each to the JAX ``TrunkedFleet`` on a band this module builds:

  - ``bench_*``: the JAX bench's trunked cell (``bench.py:516-601``): a
    P25 control channel at 4800 symbols/s whose TSDUs carry IDEN_UP, a
    Group Voice Channel Grant of TG 101 on channel 24 (+150 kHz) and
    NET_STS, and the granted LDU voice;
  - ``wide_*``: four P25 systems (each its own NAC, iden base and three
    talkgroup grants) in one RTL-SDR's 2.4 MHz band, 6 s; the calls of
    odd index fall silent after 3 s and their grants stop repeating;
  - ``dmr_*``: a DMR Tier III TSCC whose TV_GRANT CSBK grants LPCN 24,
    and dense two-slot DMR voice;
  - ``nxdn_*``: an NXDN RCCH whose CAC carries a VCALL_ASSGN of channel
    0x0A5, and the voice frames of the serial NXDN stream;
  - ``edacs_*``: an EDACS control channel with an analog voice group
    assignment of LCN 7 (the working channel is an NBFM tone);
  - ``p2_*``: a P25 Phase 1 control channel granting both slots of a
    TDMA channel (IDEN_UP TDMA), and the scrambled two-slot Phase 2 voice.

Every carrier is modulated at 48 kHz by the port's modulators (30 dB
white noise) and raised into the band by :func:`place`: each carrier's
spectrum goes into its bins of one long FFT, which is exact for integer-
Hz offsets over whole seconds and takes seconds on the card where a
sum of complex exponentials takes minutes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode

FS48 = 48000.0
BENCH_FS = 768000.0           # 16 × 48 kHz
BENCH_CENTER = 851_000_000.0
BENCH_CC_OFF = -96_000
BENCH_VC_OFF = 150_000
BENCH_TG = 101
WIDE_FS = 2_400_000.0         # one RTL-SDR's band, 50 × 48 kHz
WIDE_CENTER = 851_000_000.0
WIDE_SECONDS = 6
WIDE_SILENT_AFTER = 3.0       # odd calls fall silent here
MODE_FS = 768000.0
MODE_SECONDS = 2
EDACS_TONE_HZ = 1000.0
SNR_DB = 30.0


@functools.lru_cache(maxsize=1)
def vector() -> dict[str, np.ndarray]:
    """The arrays of ``data/fleet_tables.npz``."""
    with np.load(params.FLEET_TABLES_NPZ) as z:
        return {k: z[k] for k in z.files}


def place(parts, fs: float, n: int, device="cpu") -> torch.Tensor:
    """``[n]`` complex64 band at ``fs`` on ``device``: the sum of 48 kHz
    complex basebands ``(x48, offset_hz)``, each raised to ``fs`` and
    shifted by its integer-Hz offset through its bins of one FFT of
    length ``n`` (a periodic ideal interpolation; ``n / fs`` seconds
    must make every offset a whole number of bins)."""
    n48 = int(round(n * FS48 / fs))
    if abs(n48 * fs - n * FS48) > 1e-6 * fs:
        raise ValueError("the band length must hold whole 48 kHz samples")
    secs = n / fs
    j = torch.arange(n48, device=device)
    j = torch.where(j < (n48 + 1) // 2, j, j - n48)         # signed bins
    spec = torch.zeros(n, dtype=torch.complex128, device=device)
    for x48, off in parts:
        shift = off * secs
        if abs(shift - round(shift)) > 1e-9:
            raise ValueError(f"offset {off} Hz is not a whole bin")
        x = torch.zeros(n48, dtype=torch.complex128, device=device)
        xs = torch.as_tensor(np.asarray(x48)[:n48], device=device)
        x[:xs.shape[0]] = xs.to(torch.complex128)
        idx = torch.remainder(j + int(round(shift)), n)     # distinct
        spec[idx] += torch.fft.fft(x)
    return (torch.fft.ifft(spec) * (n / n48)).to(torch.complex64)


def cu8_planes(wide: torch.Tensor) -> torch.Tensor:
    """The SDR wire format of a band: ``[n, 2]`` uint8 offset-binary
    planes, scaled by the band's peak (the JAX bench's quantizer)."""
    pl = torch.view_as_real(wide).to(torch.float64)
    scale = float(pl.abs().max()) or 1.0
    return torch.clamp(pl / scale * 127.5 + 127.5, 0, 255).to(torch.uint8)


def c4fm48(dibits: np.ndarray, seed: int, dev_hz: float = 1800.0
           ) -> np.ndarray:
    """C4FM at 4800 symbols/s and 48 kHz with white noise at 30 dB."""
    return p25_encode.c4fm_iq(dibits, 10, FS48, dev_hz, SNR_DB, seed)


def _noisy(x: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * 10 ** (-SNR_DB / 20)).astype(np.complex64)


# -- the bands ----------------------------------------------------------------
def bench_band(tv: dict[str, np.ndarray], device="cpu",
               seconds: float = 2.0) -> torch.Tensor:
    """The JAX bench's band at 768 kHz: the CC at −96 kHz, the granted
    voice (1.98 s) at +150 kHz; 2 s by default, longer with the CC's
    dibits repeated from their start (whole seconds and halves keep
    both offsets on whole bins)."""
    n = int(seconds * BENCH_FS)
    cc = np.resize(tv["bench_cc_dibits"], int(seconds * 4800))
    return place([(c4fm48(cc, 1), BENCH_CC_OFF),
                  (c4fm48(tv["bench_vc_dibits"], 2), BENCH_VC_OFF)],
                 BENCH_FS, n, device)


def wide_band(tv: dict[str, np.ndarray], device="cpu") -> torch.Tensor:
    """6 s of the 2.4 MHz band: four CCs and twelve calls (the odd ones
    fall silent at an LDU boundary before 3 s, :func:`wide_silence`)."""
    parts = []
    for s, off in enumerate(tv["wide_cc_offs"].tolist()):
        parts.append((c4fm48(tv["wide_cc_dibits"][s], 10 + s), off))
    for j, off in enumerate(tv["wide_vc_offs"].tolist()):
        x = c4fm48(tv["wide_vc_dibits"][j], 20 + j)
        x[wide_silence(tv, j) * 10:] = 0
        parts.append((x, off))
    return place(parts, WIDE_FS, int(WIDE_SECONDS * WIDE_FS), device)


def wide_silence(tv: dict[str, np.ndarray], j: int) -> int:
    """The symbol where call ``j`` of the 2.4 MHz band falls silent: the
    sync of its first LDU that does not end by ``WIDE_SILENT_AFTER`` for
    the odd calls (their last LDU is whole), past the end for the even."""
    st = tv["wide_vc_starts"][j]
    if j % 2 == 0:
        return len(tv["wide_vc_dibits"][j])
    ldu = int(st[1] - st[0])
    return int(st[st + ldu > WIDE_SILENT_AFTER * 4800][0])


def dmr_band(tv: dict[str, np.ndarray], device="cpu") -> torch.Tensor:
    """2 s at 768 kHz: the TSCC and the granted DMR voice, both shaped
    as C4FM (as the JAX fleet test modulates them)."""
    n = int(MODE_SECONDS * MODE_FS)
    return place([(c4fm48(tv["dmr_cc_dibits"], 1), int(tv["dmr_offs"][0])),
                  (c4fm48(tv["dmr_vc_dibits"], 2), int(tv["dmr_offs"][1]))],
                 MODE_FS, n, device)


def nxdn_band(tv: dict[str, np.ndarray], device="cpu") -> torch.Tensor:
    """2 s at 768 kHz: the NXDN48 RCCH and the granted NXDN48 voice."""
    mod = nxdn_encode.modulator("nxdn48")
    n = int(MODE_SECONDS * MODE_FS)
    return place([(_noisy(mod(tv["nxdn_cc_dibits"], 20), 1),
                   int(tv["nxdn_offs"][0])),
                  (_noisy(mod(tv["nxdn_vc_dibits"], 20), 2),
                   int(tv["nxdn_offs"][1]))], MODE_FS, n, device)


def edacs_band(tv: dict[str, np.ndarray], device="cpu") -> torch.Tensor:
    """2 s at 768 kHz: the EDACS CC (2-level FSK at 9600 symbols/s) and
    the granted analog channel, a 1 kHz tone at 2.5 kHz deviation."""
    n = int(MODE_SECONDS * MODE_FS)
    n48 = int(MODE_SECONDS * FS48)
    t = np.arange(n48) / FS48
    tone = np.exp(1j * 2 * np.pi * 2500.0
                  * np.cumsum(np.sin(2 * np.pi * EDACS_TONE_HZ * t)) / FS48)
    return place([(_noisy(edacs_encode.fm_iq(tv["edacs_cc_dibits"]), 1),
                   int(tv["edacs_offs"][0])),
                  (_noisy(tone, 2), int(tv["edacs_offs"][1]))],
                 MODE_FS, n, device)


def p2_band(tv: dict[str, np.ndarray], device="cpu") -> torch.Tensor:
    """2 s at 768 kHz: the P25 Phase 1 CC granting both slots of a TDMA
    channel, and the two-slot Phase 2 voice there."""
    n = int(MODE_SECONDS * MODE_FS)
    vc = _noisy(p25_encode.tdma_fm_iq(tv["p2_vc_dibits"], 8), 2)
    return place([(c4fm48(tv["p2_cc_dibits"], 1), int(tv["p2_offs"][0])),
                  (vc, int(tv["p2_offs"][1]))], MODE_FS, n, device)


BANDS = {"dmr": dmr_band, "nxdn48": nxdn_band, "edacs": edacs_band,
         "p2": p2_band}


# the sharded fleet's mode → (band centre, the granted channel number or
# None (the iden table resolves it), the fleet_tables prefix)
SYSTEM_MODES = {"p25p1": (BENCH_CENTER, None, "bench"),
                "dmr": (460_000_000.0, 24, "dmr"),
                "nxdn48": (451_000_000.0, 0x0A5, "nxdn"),
                "edacs": (860_000_000.0, 7, "edacs"),
                "p25_mixed": (851_000_000.0, None, "p2")}


def system_offsets(tv: dict[str, np.ndarray], mode: str) -> tuple[int, int]:
    """(CC offset, granted voice offset) of a mode's band, in Hz."""
    if mode == "p25p1":
        return BENCH_CC_OFF, BENCH_VC_OFF
    cc, vc = tv[f"{SYSTEM_MODES[mode][2]}_offs"]
    return int(cc), int(vc)


def system_band(tv: dict[str, np.ndarray], mode: str, lead: int, seed: int,
                device="cpu") -> torch.Tensor:
    """One system's 2 s band at 768 kHz for the sharded fleet: the band
    of ``mode`` (``bench_band``, ``dmr_band``, ``nxdn_band``,
    ``edacs_band``, ``p2_band``) with ``lead`` random dibits before both
    carriers' streams (the tone of EDACS delayed by as many symbols) and
    white noise of seeds ``seed`` and ``seed + 1``."""
    rng = np.random.default_rng(seed)
    pre = lambda d: np.concatenate(  # noqa: E731
        [rng.integers(0, 4, lead).astype(np.uint8), d])
    n = int(MODE_SECONDS * MODE_FS)
    cc_off, vc_off = system_offsets(tv, mode)
    if mode == "p25p1":
        cc = np.resize(tv["bench_cc_dibits"], int(MODE_SECONDS * 4800))
        parts = [(p25_encode.c4fm_iq(pre(cc), 10, FS48, 1800.0, SNR_DB,
                                     seed), cc_off),
                 (p25_encode.c4fm_iq(pre(tv["bench_vc_dibits"]), 10, FS48,
                                     1800.0, SNR_DB, seed + 1), vc_off)]
    elif mode == "dmr":
        parts = [(p25_encode.c4fm_iq(pre(tv["dmr_cc_dibits"]), 10, FS48,
                                     1800.0, SNR_DB, seed), cc_off),
                 (p25_encode.c4fm_iq(pre(tv["dmr_vc_dibits"]), 10, FS48,
                                     1800.0, SNR_DB, seed + 1), vc_off)]
    elif mode == "nxdn48":
        mod = nxdn_encode.modulator("nxdn48")
        parts = [(_noisy(mod(pre(tv["nxdn_cc_dibits"]), 20), seed), cc_off),
                 (_noisy(mod(pre(tv["nxdn_vc_dibits"]), 20), seed + 1),
                  vc_off)]
    elif mode == "edacs":
        n48 = int(MODE_SECONDS * FS48)
        t = np.arange(n48) / FS48
        tone = np.exp(1j * 2 * np.pi * 2500.0 * np.cumsum(
            np.sin(2 * np.pi * EDACS_TONE_HZ * t)) / FS48)
        tone[:lead * 5] = 0
        parts = [(_noisy(edacs_encode.fm_iq(pre(tv["edacs_cc_dibits"])),
                         seed), cc_off),
                 (_noisy(tone, seed + 1), vc_off)]
    elif mode == "p25_mixed":
        parts = [(p25_encode.c4fm_iq(pre(tv["p2_cc_dibits"]), 10, FS48,
                                     1800.0, SNR_DB, seed), cc_off),
                 (_noisy(p25_encode.tdma_fm_iq(pre(tv["p2_vc_dibits"]), 8),
                         seed + 1), vc_off)]
    else:
        raise ValueError(f"no system band for mode {mode!r}")
    return place(parts, MODE_FS, n, device)


def extractor_gain(fs: float, offs, device="cpu") -> np.ndarray:
    """The row extractor's gain at each offset, in dB against a tone at a
    bank bin's centre: a 0.1 s tone at the offset, extracted on its row.
    The JAX package's bank (``channelize``) applies branch i's taps to
    x[mN + i] and folds the rows' band, so the gain dips near ±13 kHz
    from a bin's centre (ROADMAP queue 3); the port copies it."""
    from dsdneo_tpu_torch.engine.fleettrunk import make_row_extractor
    n = int(fs / 10)
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    ex = make_row_extractor(int(round(fs / FS48)))

    def level(off):
        x = torch.exp(2j * np.pi * off * t).to(torch.complex64)
        r = ex(x, torch.tensor([off], dtype=torch.int32, device=device))
        return float(r[0, 400:-400].abs().mean())
    ref = level(0)
    return np.array([20 * np.log10(level(int(o)) / ref) for o in offs])


# -- judges -------------------------------------------------------------------
def row_frames(pipe, row: int) -> np.ndarray:
    """The IMBE bits ``[F, 88]`` the P25 voice pipeline decoded on
    ``row`` in its last block, in frame order."""
    if pipe.last_frames is None:
        return np.zeros((0, 88), np.uint8)
    bits, _errs, fch, forder = pipe.last_frames
    sel = np.flatnonzero(np.asarray(fch) == row)
    bits = bits.cpu().numpy() if torch.is_tensor(bits) else bits
    return bits[sel[np.argsort(np.asarray(forder)[sel], kind="stable")]]


def judge_ldus(frames: np.ndarray, bits88: np.ndarray, starts: np.ndarray,
               t0: int, n_sym: int, need: int, margin: int = 16,
               max_bad: int = 0) -> tuple[int, int]:
    """Hold a row's decoded frames of one block to a call's vector: the
    frames, 9 an LDU, must be consecutive LDUs of the vector (the first
    is the LDU nearest in bits) with its IMBE bits, and must hold every
    LDU whose sync lies at least ``margin`` symbols inside the block
    (the block starts at stream symbol ``t0`` and holds ``n_sym``; an
    LDU at s is whole when s − t0 + ``need`` < ``n_sym``).  At most
    ``max_bad`` frames may differ from the vector's bits.  Returns (LDUs
    accepted, frames that differ)."""
    if frames.shape[0] % 9:
        raise AssertionError(f"{frames.shape[0]} frames, not whole LDUs")
    n = frames.shape[0] // 9
    rel = starts - t0
    must = np.flatnonzero((rel >= margin) & (rel + need + margin < n_sym))
    if n == 0:
        if must.size:
            raise AssertionError(f"no LDU accepted, {must.size} whole")
        return 0, 0
    vec = bits88.reshape(-1, 9, 88)
    got = frames.reshape(n, 9, 88)
    if n > vec.shape[0]:
        raise AssertionError(f"{n} LDUs accepted, the vector holds "
                             f"{vec.shape[0]}")
    k0 = int(np.argmin((vec[:vec.shape[0] - n + 1] != got[0]).sum((1, 2))))
    if k0 + n > vec.shape[0]:
        raise AssertionError(f"{n} LDUs accepted from LDU {k0} of "
                             f"{vec.shape[0]}")
    bad = int((got != vec[k0:k0 + n]).any(-1).sum())
    if bad > max_bad:
        raise AssertionError(f"LDUs {k0}..{k0 + n - 1}: {bad} frames' IMBE "
                             f"bits differ from the vector (at most "
                             f"{max_bad})")
    if not set(must.tolist()) <= set(range(k0, k0 + n)):
        raise AssertionError(f"accepted LDUs {k0}..{k0 + n - 1}, whole "
                             f"ones {must.tolist()}")
    return n, bad
