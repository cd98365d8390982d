"""The NXDN serial decoder of the PyTorch port against the JAX package's,
on the CPU.

Module parity on inputs drawn from seeds with numpy: ``crc6_nxdn`` and
``crc12_nxdn``, the PN9 scramble positions (the default seed and
others), the permutation and LICH tables; ``NxdnDecoder.handle`` on
random dibit streams with hits of every NXDN sync (the pattern of
``tests/test_fuzz_robustness.py``), both packages' events equal.

``demod_fm`` for ``nxdn48`` (2400 symbols/s, the ``6k25`` profile) and
``nxdn96`` (4800, ``12k5``): the dibits equal off the slicer's
thresholds, the soft symbols within 1e-3.

``decode_samples`` end to end (``device="cpu"``) on ~4 s of the
``nxdn_*`` stream of ``data/serial_tables.npz`` as NXDN48, on an
inverted channel, and as NXDN96, and once with the ``nxdn_pn95_seed``
override: every event's line, position, protocol and fields equal, the
dibits equal, the AMBE bits handed to ``decode_ambe_2450`` equal, the
port's decode holding the vector (``engine.serialvec.judge_nxdn``), and
the PCM within 2e-3 of the JAX package's peak (the synthesizer sums
float32 in another order).
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import demod as jdemod  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.nxdn import decoder as jnx  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
import dsdneo_tpu.vocoder.mbe as jmbe  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import demod as tdemod  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.nxdn import decoder as tnx  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402
import dsdneo_tpu_torch.vocoder.mbe as tmbe  # noqa: E402

N_SYM = {"nxdn48": 4 * 2400, "nxdn96": 4 * 4800}     # 4 s at each rate
PCM_REL = 2e-3
SOFT_TOL = 1e-3
EDGE = 0.05


def _both(x, mode, **kw):
    """``decode_samples`` of both packages on ``x``: the events, dibits,
    spied AMBE bits and PCM agree.  Returns (port ctx, port spy)."""
    with SV.AmbeSpy(jmbe) as js:
        jc = jdec.decode_samples(x, mode, **kw)
    with SV.AmbeSpy(tmbe) as ts:
        tc = tdec.decode_samples(x, mode, device="cpu", **kw)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    assert len(js.bits) == len(ts.bits)
    if js.bits:
        np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))
    a, b = SV.pcm(jc), SV.pcm(tc)
    assert a.shape == b.shape and b.dtype == np.float32
    if a.size:
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    return tc, ts


@pytest.mark.parametrize("mode,invert", [("nxdn48", False),
                                         ("nxdn48", True),
                                         ("nxdn96", False)],
                         ids=["nxdn48", "nxdn48_inverted", "nxdn96"])
def test_nxdn_stream(mode, invert):
    tv = SV.vector()
    n = N_SYM[mode]
    tc, ts = _both(SV.nxdn_iq(tv, n, mode, invert=invert), mode)
    got = SV.judge_nxdn(tv, tc, ts, mode, n)
    assert got["frames"] >= 45 and got["vcalls"] >= 10
    assert got["facch"] >= 10 and got["ambe_frames"] >= 150
    assert tc.state.nxdn_ran == int(tv["nxdn_ids"][0])


def test_nxdn_pn95_seed_override():
    """``nxdn_pn95_seed`` other than 0xE4 takes the other scramble."""
    tv = SV.vector()
    x = SV.nxdn_iq(tv, 4800, "nxdn48")
    tc, _ts = _both(x, "nxdn48", state_attrs={"nxdn_pn95_seed": 0x1A5})
    assert not any("VCALL" in e.line for e in tc.events)


def test_crcs_and_tables():
    rng = np.random.default_rng(60)
    for _ in range(300):
        b = rng.integers(0, 2, int(rng.integers(1, 120))).astype(np.uint8)
        assert tnx.crc6_nxdn(b) == jnx.crc6_nxdn(b)
        assert tnx.crc12_nxdn(b) == jnx.crc12_nxdn(b)
    for seed in (0xE4, 0x1FF, 0x001, 0x0A5):
        np.testing.assert_array_equal(tnx._pn9_scramble_positions(seed),
                                      jnx._pn9_scramble_positions(seed))
    for name in ("_SCRAMBLE_POS", "_PERM_12_5", "_PERM_16_9",
                 "_PERM_12_25"):
        np.testing.assert_array_equal(getattr(tnx, name),
                                      getattr(jnx, name))
    assert tnx._LICH_PROFILES == jnx._LICH_PROFILES


def _fuzz(pkg, dibits, soft, picks, mode):
    base, fs = (jbase, jfs) if pkg == "jax" else (tbase, tfs)
    nx = jnx if pkg == "jax" else tnx
    ctx = (base.DecoderContext() if pkg == "jax"
           else base.DecoderContext(device="cpu"))
    ctx.mode_name = mode
    dec = nx.NxdnDecoder()
    defs = [d for d in fs.SYNC_DEFS if d.protocol == "nxdn"]
    for pos, k in picks:
        hit = fs.SyncHit(pos=pos, score=0.9, sync=defs[k])
        dec.handle(base.DibitReader(dibits, soft, pos=hit.end,
                                    frame_start=hit.pos,
                                    invert=hit.sync.inverted), hit, ctx)
    return ctx


@pytest.mark.parametrize("seed", range(6))
def test_handle_on_random_streams(seed):
    """Random dibits and soft values with hits of random NXDN syncs, most
    followed by a valid LICH: the same events, and the same voice bits,
    from both packages' ``handle``."""
    rng = np.random.default_rng(300 + seed)
    dibits = rng.integers(0, 4, 4000).astype(np.uint8)
    soft = rng.normal(0, 3, 4000).astype(np.float32)
    defs = [d for d in tfs.SYNC_DEFS if d.protocol == "nxdn"]
    picks = [(int(p), int(rng.integers(0, len(defs))))
             for p in sorted(rng.choice(np.arange(0, 3950, 200), 10,
                                        replace=False))]
    pn = np.zeros(8, np.uint8)
    pn[tnx._SCRAMBLE_POS[tnx._SCRAMBLE_POS < 8]] = 2
    for p, k in picks[:-1]:
        # a valid LICH after most hits, so the SACCH, FACCH1, CAC and
        # voice readers run
        lich = int(rng.choice([0x01, 0x20, 0x32, 0x34, 0x36, 0x38, 0x28,
                               0x7F]))
        full = lich << 1
        full |= ((full >> 7) ^ (full >> 6) ^ (full >> 5)) & 1
        d = np.array([((full >> (7 - i)) & 1) << 1 for i in range(8)])
        dibits[p + 10:p + 18] = d ^ pn ^ (2 if defs[k].inverted else 0)
    mode = ("nxdn48", "nxdn96")[seed % 2]
    with SV.AmbeSpy(jmbe) as js:
        jc = _fuzz("jax", dibits, soft, picks, mode)
    with SV.AmbeSpy(tmbe) as ts:
        tc = _fuzz("torch", dibits, soft, picks, mode)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    assert len(tc.events) >= 9
    assert len(js.bits) == len(ts.bits)
    if js.bits:
        np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))


@pytest.mark.parametrize("mode", ["nxdn48", "nxdn96"])
def test_demod_fm(mode):
    x = SV.nxdn_iq(SV.vector(), N_SYM[mode] // 2, mode)
    jd, js = jdemod.demod_fm(x, mode)
    td, ts = tdemod.demod_fm(x, mode, device="cpu")
    assert np.abs(np.asarray(js) - ts).max() <= SOFT_TOL
    off = np.min(np.abs(np.abs(js)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    assert off.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(jd)[off], td[off])
