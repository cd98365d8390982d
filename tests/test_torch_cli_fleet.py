"""The port's CLI on its many-channel branches against the JAX
package's, both in process with ``--platform cpu``: ``--trunk-wideband``
(the closed-loop trunked fleet), ``--wideband`` (channelize, then the
serial decode of every active channel) and ``--fleet`` (a
``FleetMonitor`` with a control and a voice group).

The band of ``--trunk-wideband`` is the JAX bench's fleet cell
(``engine/fleetvec``: the P25 CC at −96 kHz granting TG 101 at +150 kHz
of a 768 kHz band) made 2.5 s long, so the CLI's 1 s steps end with a
partial block of 0.5 s.  The JAX CC body keeps the first block's symbol
count for that block (``dsdneo_tpu/engine/fleettrunk.py:549-556``); the
port keys its body on the block length.  Both CLIs print the same lines
and write the same PCM here; the difference shows in the control
channel's event positions, which the library test below pins.

Equal means: the printed lines, and the sink's WAV within 2e-3 of its
peak.  With ``DSD_NEO_DEEMPH``/``DSD_NEO_AUDIO_LPF`` set, the port
conditions the rows it writes (the JAX CLI writes them raw), its filter
state carried across the 1 s blocks: its WAV is the library fleet's PCM
conditioned in one call on each row's concatenated blocks, bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu import cli as J  # noqa: E402
from dsdneo_tpu.engine import fleettrunk as JF  # noqa: E402
from dsdneo_tpu_torch import cli as P  # noqa: E402
from dsdneo_tpu_torch.dsp.audio_filters import condition_audio  # noqa: E402
from dsdneo_tpu_torch.engine import fleettrunk as PF  # noqa: E402
from dsdneo_tpu_torch.engine import fleetvec as FV  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.io.iq import IqMetadata, write_iq_capture  # noqa: E402
from test_torch_cli import (assert_same_text, assert_wav_close,  # noqa: E402,E501  (tests/)
                            both, run, wav_frames)

B = int(FV.BENCH_FS)                 # the CLI's 1 s steps
SPEC = f" {FV.BENCH_CC_OFF}:4:p25p1"  # the leading space keeps "-96000" a value


def bench_band_25() -> np.ndarray:
    """2.5 s of the bench cell (its CC dibits repeated)."""
    return FV.bench_band(FV.vector(), seconds=2.5).numpy()


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("bands")
    out = {"band": bench_band_25()}
    write_iq_capture(str(d / "bench.iq"), out["band"], IqMetadata(
        sample_format="cf32", sample_rate_hz=B,
        center_frequency_hz=int(FV.BENCH_CENTER)))
    out["bench"] = str(d / "bench.iq")
    # 3 s of the cell with the call's dibits repeated as well: the call
    # goes on past the second block
    tv = FV.vector()
    n = 3 * 4800
    out["long_band"] = FV.place(
        [(FV.c4fm48(np.resize(tv["bench_cc_dibits"], n), 1),
          FV.BENCH_CC_OFF),
         (FV.c4fm48(np.resize(tv["bench_vc_dibits"], n), 2),
          FV.BENCH_VC_OFF)], FV.BENCH_FS, 3 * B).numpy()
    write_iq_capture(str(d / "long.iq"), out["long_band"], IqMetadata(
        sample_format="cf32", sample_rate_hz=B,
        center_frequency_hz=int(FV.BENCH_CENTER)))
    out["long"] = str(d / "long.iq")
    # 16 bins of 48 kHz: 2 s of the P25 call at +96 kHz, the bench CC at
    # −96 kHz
    sv = SV.vector()
    wide = FV.place([(SV.p25_iq(sv, 2 * 4800), 96_000),
                     (FV.c4fm48(tv["bench_cc_dibits"], 1), -96_000)],
                    FV.BENCH_FS, 2 * B).numpy()
    write_iq_capture(str(d / "wide.iq"), wide, IqMetadata(
        sample_format="cf32", sample_rate_hz=B))
    out["wide"] = str(d / "wide.iq")
    # 48 kHz: 1 s of the bench CC, then 2 s of the P25 call
    x = np.concatenate([FV.c4fm48(tv["bench_cc_dibits"][:4800], 1),
                        SV.p25_iq(sv, 2 * 4800)])
    write_iq_capture(str(d / "fleet.iq"), x, IqMetadata(
        sample_format="cf32", sample_rate_hz=48000))
    out["fleet"] = str(d / "fleet.iq")
    return out


def library(band: np.ndarray) -> tuple[list, list]:
    """The library fleet stepped over ``band`` as the CLI steps it: each
    block's PCM (all rows) and the (block, row) pairs the CLI's sink
    writes."""
    f = PF.TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], 4,
                        center_hz=FV.BENCH_CENTER, cc_device_pick=True,
                        device="cpu")
    blocks, written = [], []
    for i in range(0, band.shape[0], B):
        pcm = f.step(band[i:i + B])
        if pcm.shape[1]:
            written += [(len(blocks), r) for r in f.calls
                        if np.abs(pcm[r]).mean() > 1e-4]
            blocks.append(pcm)
    return blocks, written


def quantized(x: np.ndarray) -> np.ndarray:
    """write_wav's quantizer: clipped to [-1, 1], times 32767,
    truncated."""
    return ((np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
            / 32768.0).astype(np.float32)


def test_trunk_wideband_against_jax_and_the_library(caps, tmp_path):
    """The closed loop from both CLIs: the grant, the summary, the
    granted call's PCM in the WAV.  The port's sink holds exactly the
    library fleet's PCM of the same three blocks (the partial one
    included)."""
    jr, pr = both(tmp_path, ["--iq-replay", caps["bench"], "--trunk-wideband",
                             SPEC, "-o", "wav:{out}/voice.wav"])
    assert_same_text(jr, pr)
    assert pr[0] == 0
    assert "GRANT TG 101 -> row 0 @ 851.1500 MHz" in pr[2]
    assert "1 grants, 25 refreshes, 0 releases, 0 unresolved, " \
        "0 busy-drops over 3 blocks" in pr[2]
    assert_wav_close(os.path.join(jr[3], "voice.wav"),
                     os.path.join(pr[3], "voice.wav"))
    blocks, written = library(caps["band"])
    got = wav_frames(os.path.join(pr[3], "voice.wav"))[:, 0]
    want = quantized(np.concatenate([blocks[b][r] for b, r in written]))
    assert got.shape == want.shape and got.size == 8640
    assert np.array_equal(got, want)


def test_trunk_wideband_conditioning_carries_across_blocks(
        caps, tmp_path, monkeypatch):
    """``DSD_NEO_DEEMPH=nfm DSD_NEO_AUDIO_LPF=3400`` on the port's
    ``--trunk-wideband`` over 3 s of the bench cell with the granted
    call's dibits repeated, so that the call is written in two blocks:
    the WAV is the library fleet's rows, each concatenated over the
    blocks and conditioned in one call, bit for bit.  Each block's row
    ends in silence here (1,440 and 2,880 samples of its 8,640), in which
    the filters decay to zero, so conditioning a block at a time gives
    the same WAV on this band; the carry itself is held by
    ``test_torch_audio_filters.py`` (CPU) and ``test_torch_burst_card.py``
    (K8)."""
    monkeypatch.setenv("DSD_NEO_DEEMPH", "nfm")
    monkeypatch.setenv("DSD_NEO_AUDIO_LPF", "3400")
    rc, _so, se = run(P.main, ["--platform", "cpu", "--iq-replay",
                               caps["long"], "--trunk-wideband", SPEC,
                               "-o", "wav:voice.wav"], str(tmp_path))
    assert rc == 0 and "GRANT TG 101" in se
    blocks, written = library(caps["long_band"])
    assert [b for b, _r in written] == [0, 1]    # two blocks with PCM
    rows = sorted({r for _b, r in written})
    whole = condition_audio(torch.as_tensor(np.concatenate(
        [blk[rows] for blk in blocks], axis=1)), "nfm", 3400).numpy()
    edges = np.cumsum([0] + [blk.shape[1] for blk in blocks])
    want = np.concatenate([whole[rows.index(r), edges[b]:edges[b + 1]]
                           for b, r in written])
    got = wav_frames(str(tmp_path / "voice.wav"))[:, 0]
    assert got.size == 17280 and np.array_equal(got, quantized(want))


def test_partial_block_keys_on_its_length():
    """The partial third block through the library fleets: the JAX CC
    body, compiled for the first block's symbol count, numbers the
    block's five TSDUs from 1 (positions 201-205); the port's, keyed on
    the block length, from 0 (200-204), as a fresh JAX fleet fed the
    partial block first does.  The lines and every whole block agree."""
    band = bench_band_25()
    per = {}
    for name, mk in (
            ("jax", lambda: JF.TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF],
                                            4, center_hz=FV.BENCH_CENTER,
                                            cc_device_pick=True)),
            ("port", lambda: PF.TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF],
                                             4, center_hz=FV.BENCH_CENTER,
                                             cc_device_pick=True,
                                             device="cpu"))):
        f = mk()
        blocks = []
        for i in range(0, band.shape[0], B):
            k0 = len(f.cc_pipe.ctxs[0].events)
            f.step(band[i:i + B])
            blocks.append([(e.line, e.pos)
                           for e in f.cc_pipe.ctxs[0].events[k0:]])
        per[name] = (f, blocks)
    (jf, jb), (pf, pb) = per["jax"], per["port"]
    assert jb[:2] == pb[:2]
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(jf.stats)
    assert [ln for ln, _ in jb[2]] == [ln for ln, _ in pb[2]]
    assert sorted({p for _, p in pb[2]}) == [200, 201, 202, 203, 204]
    assert sorted({p for _, p in jb[2]}) == [201, 202, 203, 204, 205]
    fresh = PF.TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], 4,
                            center_hz=FV.BENCH_CENTER, cc_device_pick=True,
                            device="cpu")
    fresh.step(band[2 * B:])
    assert [p + 200 for p in (e.pos for e in fresh.cc_pipe.ctxs[0].events)] \
        == [p for _, p in pb[2]]


def test_wideband_16_bins(caps, tmp_path):
    jr, pr = both(tmp_path, ["-f1", "--wideband", "16", "--iq-replay",
                             caps["wide"]])
    assert_same_text(jr, pr)
    assert "[+0.096000 MHz] channel" in pr[2]
    assert "[+0.096000 MHz] Sync: +P25p1" in pr[2]


def test_fleet_groups(caps, tmp_path):
    jr, pr = both(tmp_path, ["--iq-replay", caps["fleet"], "--fleet",
                             "p25p1:cc:2,p25p1:voice:2"])
    assert_same_text(jr, pr)
    assert "group p25p1/cc x2: 102 events" in pr[2]
    assert "group p25p1/voice x2: 2.16 s audio per channel" in pr[2]
    assert "Identifier Update" in pr[2]


def test_trunk_wideband_bad_spec_exits_2(caps, tmp_path):
    rc, _, se = run(P.main, ["--platform", "cpu", "--iq-replay",
                             caps["bench"], "--trunk-wideband", "x:y"],
                    str(tmp_path))
    assert rc == 2 and "bad --trunk-wideband spec" in se
