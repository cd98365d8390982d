"""The closed-loop trunked fleet (``engine/fleettrunk.TrunkedFleet``,
P25 Phase 1) of the PyTorch port against the JAX package's, on the CPU,
on the band of ``tests/test_fleettrunk.py`` (a P25 CC at −96 kHz whose
grants of TG 101 resolve to +150 kHz, LDU voice there until 3 s, 1 s
blocks): the cases of that file on both packages (the grant retargets a
row and the row decodes voice, the parked row stays silent, the release
after the hangtime parks it again, the CU8 wire, the prefetch path bit
for bit, the device pick against the host pick), and ``step_pipelined``
and ``row_dicts``.

Equal means: ``stats``, the ``log`` lines, the offsets, the calls, each
CC context's events (lines, positions, fields), and the PCM within
2e-3 of its peak (the rows agree with the JAX extractor's within 2e-6 of
their peak, ``test_torch_channelizer.py``).  The JAX fleet jits its own
programs.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.engine import fleettrunk as J
from dsdneo_tpu_torch.engine import fleettrunk as P
from dsdneo_tpu_torch.engine import serialvec as SV
from dsdneo_tpu_torch.parallel import mesh as PM
from test_fleettrunk import (CC_OFF, CENTER, FS, TG, VC_OFF,  # tests/
                             _build_wideband)

B = int(FS)
KW = dict(n_voice_rows=2, center_hz=CENTER, hangtime_s=0.6,
          grant_grace_s=0.5)


@pytest.fixture(scope="module")
def wide():
    return _build_wideband()


def _run(wide, n_blocks=4, **kw):
    out = {}
    for name, mk in (("jax", lambda: J.TrunkedFleet(FS, [CC_OFF], **KW,
                                                     **kw)),
                     ("port", lambda: P.TrunkedFleet(FS, [CC_OFF], **KW,
                                                      **kw, device="cpu"))):
        f = mk()
        out[name] = (f, [f.step(wide[i * B:(i + 1) * B])
                         for i in range(n_blocks)])
    return out


def assert_fleets_equal(jf, pf, pj, pp):
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(jf.stats)
    assert pf.log == jf.log
    assert pf.offs.tolist() == jf.offs.tolist()
    assert {r: (c.tg, c.src, c.freq_hz, c.pcm_samples)
            for r, c in pf.calls.items()} == \
        {r: (c.tg, c.src, c.freq_hz, c.pcm_samples)
         for r, c in jf.calls.items()}
    for c in range(jf.n_cc):
        assert SV.events_equal(jf.cc_pipe.ctxs[c].events,
                               pf.cc_pipe.ctxs[c].events) is None
    for a, b in zip(pj, pp):
        a = np.asarray(a)
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a - b).max() <= 2e-3 * np.abs(a).max()


@pytest.fixture(scope="module")
def host_pick(wide):
    return _run(wide)


@pytest.fixture(scope="module")
def device_pick(wide):
    return _run(wide, cc_device_pick=True)


def test_grant_retargets_row_and_decodes_voice(host_pick):
    jf, pj = host_pick["jax"]
    pf, pp = host_pick["port"]
    assert_fleets_equal(jf, pf, pj, pp)
    assert pf.stats.grants == 1 and pf.stats.releases == 1
    assert pf.stats.grant_refreshes >= 2
    assert pp[0].shape == (2, 0)
    e = np.abs(pp[1]).mean(axis=1)
    assert e[0] > 1e-3 and e[1] < e[0] / 10
    assert np.abs(pp[2][0]).mean() > 1e-3
    assert not pf.calls and pf.offs[pf.n_cc] == CC_OFF
    assert pf.log[0].endswith(f"GRANT TG {TG} -> row 0 @ 851.1500 MHz "
                              "(sys 0)")


def test_device_pick_matches_the_jax_device_pick(device_pick):
    jf, pj = device_pick["jax"]
    pf, pp = device_pick["port"]
    assert pf.cc_device_pick and jf.cc_device_pick
    assert_fleets_equal(jf, pf, pj, pp)


def test_device_pick_equals_host_pick(host_pick, device_pick):
    """The control plane of the device pick equals the host pick's:
    grants, refreshes, releases, offsets, log and the voice PCM."""
    hf, hp = host_pick["port"]
    df, dp = device_pick["port"]
    assert dataclasses.asdict(df.stats) == dataclasses.asdict(hf.stats)
    assert df.offs.tolist() == hf.offs.tolist() and df.log == hf.log
    for a, b in zip(hp, dp):
        np.testing.assert_array_equal(a, b)


def test_device_pick_body_against_jax(wide):
    """``parallel.mesh._p25_cc_body``: the blobs, valid mask and NID
    messages of the CC row equal the JAX body's, and the shoulder mask
    equals the JAX function's on the same positions; how often a TSDU's
    shoulder survives the 8-position mask (parsed twice) is counted."""
    import jax
    import jax.numpy as jnp
    import torch
    from dsdneo_tpu.parallel import mesh as JM
    from dsdneo_tpu_torch import params
    rows_j = np.asarray(J.make_row_extractor(16)(
        jnp.asarray(wide[:B]), jnp.asarray([CC_OFF], np.int32)))
    planes = np.stack([rows_j.real, rows_j.imag], -1).astype(np.float32)
    n = planes.shape[1]
    jb = jax.jit(JM._p25_cc_body(1, n, 48000.0, 16, 0.62, nac_out=True,
                                 dedup=True))(jnp.asarray(planes))
    pb = PM._p25_cc_body(1, n, 48000.0, 16, 0.62, nac_out=True, dedup=True,
                         tables=params.load_cc("p25", "cpu"))(
        torch.from_numpy(planes))
    valid = np.asarray(jb[1])
    np.testing.assert_array_equal(pb[1].numpy(), valid)
    np.testing.assert_array_equal(pb[2].numpy(), np.asarray(jb[2]))
    np.testing.assert_array_equal(pb[0].numpy()[valid],
                                  np.asarray(jb[0])[valid])
    assert valid.sum() >= 5
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 60, (3, 16))
    np.testing.assert_array_equal(
        PM._topk_shoulder_mask(torch.from_numpy(idx)).numpy(),
        np.asarray(JM._topk_shoulder_mask(jnp.asarray(idx))))
    # a TSDU parsed twice: two valid candidates closer than a TSDU's
    # first trellis block (its acceptance extent), i.e. a shoulder the
    # 8-position mask let through
    from dsdneo_tpu_torch.engine.batched import frontend_step
    from dsdneo_tpu_torch.engine.voicebatch import correlate_syncs_device
    t = params.load_cc("p25", "cpu").front
    _d, soft, _p = frontend_step(torch.from_numpy(planes), t.taps, 10.0,
                                 n // 10 - 2, t.four_level)
    bs = torch.amax(correlate_syncs_device(soft, t.sync_levels), dim=1)
    idx = torch.sort(bs, dim=1, descending=True, stable=True)[1][0, :16]
    pos = np.sort(idx.numpy()[valid[0]])
    twice = int((np.diff(pos) < 24 + 32 + 98).sum())
    assert twice == 0, pos


def test_cu8_wire_format_decodes(wide):
    scale = np.abs(wide).max()
    pl = np.stack([wide.real, wide.imag], axis=-1) / scale
    wide_u8 = np.clip(pl * 127.5 + 127.5, 0, 255).astype(np.uint8)
    out = _run(wide_u8, n_blocks=2)
    jf, pj = out["jax"]
    pf, pp = out["port"]
    assert_fleets_equal(jf, pf, pj, pp)
    assert pf.stats.grants == 1 and pf.offs[pf.n_cc] == VC_OFF
    assert np.abs(pp[1][0]).mean() > 1e-3


def test_prefetch_path_bit_identical(wide, host_pick):
    """``step(None, prefetch=...)`` gives the plain step's PCM, stats and
    control plane bit for bit; a fresh block supersedes a queued one."""
    pf_plain, out_plain = host_pick["port"]
    blocks = [wide[i * B:(i + 1) * B] for i in range(3)]
    pre = P.TrunkedFleet(FS, [CC_OFF], **KW, device="cpu")
    out_pre = [pre.step(blocks[0], prefetch=blocks[1]),
               pre.step(None, prefetch=blocks[2]),
               pre.step(None)]
    for a, b in zip(out_plain, out_pre):
        np.testing.assert_array_equal(a, b)
    assert pre.calls.keys() == {0}
    pre.step(blocks[1], prefetch=blocks[2])
    pre.step(blocks[1])
    assert pre._next_block is None
    assert any("WARN: prefetched block dropped" in line for line in pre.log)
    with pytest.raises(ValueError):
        pre.step(None)


def test_step_pipelined_against_jax(wide, host_pick):
    """``step_pipelined`` gives each block's PCM one block later, equal to
    the JAX package's, and the plain step's PCM where the call set is
    the same; ``flush_pipelined`` returns the last block."""
    out = {}
    for name, f in (("jax", J.TrunkedFleet(FS, [CC_OFF], **KW)),
                    ("port", P.TrunkedFleet(FS, [CC_OFF], **KW,
                                            device="cpu"))):
        pcm = [f.step_pipelined(wide[i * B:(i + 1) * B]) for i in range(4)]
        pcm.append(f.flush_pipelined())
        out[name] = (f, pcm)
    jf, pj = out["jax"]
    pf, pp = out["port"]
    assert_fleets_equal(jf, pf, pj, pp)
    assert pp[0].shape == (2, 0)
    assert sum(np.abs(p).mean() > 1e-3 for p in pp if p.size) >= 1
    assert pf.flush_pipelined().shape == (2, 0)


def test_row_dicts(host_pick, wide):
    jf, _ = host_pick["jax"]
    pf, _ = host_pick["port"]
    assert pf.row_dicts() == jf.row_dicts()
    f = P.TrunkedFleet(FS, [CC_OFF], **KW, device="cpu")
    f.step(wide[:B])
    rows = f.row_dicts()
    assert rows[0]["state"] == "cc" and rows[1]["state"] == f"voice TG {TG}"
    assert rows[1]["freq_hz"] == VC_OFF and rows[2]["state"] == "idle"


def test_bad_band_rates():
    with pytest.raises(ValueError):
        P.TrunkedFleet(50000.0, [0], 1, device="cpu")
    with pytest.raises(ValueError):
        P.TrunkedFleet(FS, [0], 1, mode="ysf", device="cpu")
