"""The serial decode path of the PyTorch port against the JAX package's
(``engine/decoder.decode_samples``, ``engine/demod.py``,
``symbols/framesync.py``, ``symbols/timing.recover_symbols_fixed``,
``engine/modes.py``, ``runtime/config.py``), on the CPU, on ~4 s of each
stream of ``data/serial_tables.npz`` (modulated by the port; the same
complex64 samples go to both packages):

  - ``decode_samples`` end to end on the P25 Phase 1 call (C4FM, the
    ADP-keyed superframes decrypted with the key in a ``KeyRing``), the
    same call through ``cqpsk=True`` with a carrier offset, the call on
    an inverted channel with and without ``force_polarity``, and the
    EDACS/ProVoice stream in the ``provoice`` and ``edacs`` modes:
    every event line, position and field equal (IMBE and IMBE-7100 bits
    bit for bit), the voice frames' parameter bits through ``mbe_sink``
    equal, both decodes holding the vector (``engine.serialvec``
    judges), and the PCM within 2e-3 of the JAX package's peak (the
    voice paths' bound: the synthesizer's float32 sums run in another
    order);
  - the ``DSD_NEO_WINDOW_FREEZE`` and ``DSD_NEO_CHANNEL_LPF=0`` branches
    and the CQPSK knobs, set through the environment for both packages:
    the events equal, and ``demod_fm``'s dibits equal off the slicer's
    thresholds, its soft symbols within 1e-3;
  - ``recover_symbols_fixed`` bit for bit (inside ``jax.jit``), the
    host sync hunt (``correlate_syncs``, ``find_syncs``,
    ``polarity_twin``) equal, ``demod_disc`` on dibits off the
    thresholds, the mode table equal;
  - the entry point takes the card when no device is given (every
    mode has its serial decoder; M17, P25p2 and ``auto`` are held to
    the JAX package by ``test_torch_m17_serial.py``,
    ``test_torch_p25p2_serial.py`` and ``test_torch_detect_capture.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none

from dsdneo_tpu.crypto.keyring import KeyRing as JKeyRing  # noqa: E402
from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import demod as jdemod  # noqa: E402
from dsdneo_tpu.engine import modes as jmodes  # noqa: E402
from dsdneo_tpu.runtime import config as jcfg  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
from dsdneo_tpu.symbols import timing as jtiming  # noqa: E402
from dsdneo_tpu_torch.crypto.keyring import KeyRing as TKeyRing  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import demod as tdemod  # noqa: E402
from dsdneo_tpu_torch.engine import modes as tmodes  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.runtime import config as tcfg  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402
from dsdneo_tpu_torch.symbols import timing as ttiming  # noqa: E402

P25_SYM = 4 * 4800                  # 4 s of the P25 call
PV_SYM = 4 * 9600                   # 4 s of the EDACS/ProVoice stream
PCM_REL = 2e-3                      # PCM, as a fraction of the peak
SOFT_TOL = 1e-3                     # demod_fm soft symbols
EDGE = 0.05                         # "off the thresholds": |soft − t| > EDGE


def _keyrings():
    _n, _tg, _src, key, kid, _seed = (int(v) for v in
                                      SV.vector()["p25_ids"])
    j, t = JKeyRing(), TKeyRing()
    j.scalar[kid] = key
    t.scalar[kid] = key
    return j, t


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    """Both packages read the environment afresh in each test."""
    monkeypatch.setattr(jcfg, "_config", None)
    monkeypatch.setattr(tcfg, "_config", None)


def _both(x, mode, **kw):
    """``decode_samples`` of both packages on ``x``; the events equal and
    the PCM within the bound.  Returns (JAX ctx, port ctx, sinks)."""
    jk, tk = _keyrings()
    js, ts = SV.ImbeSink(), SV.ImbeSink()
    jc = jdec.decode_samples(x, mode, keyring=jk, mbe_sink=js, **kw)
    tc = tdec.decode_samples(x, mode, keyring=tk, mbe_sink=ts,
                             device="cpu", **kw)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    assert (jc.n_syncs, jc.mode_name) == (tc.n_syncs, tc.mode_name)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    assert len(js.bits) == len(ts.bits) and js.errs == ts.errs
    if js.bits:
        np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))
    a, b = SV.pcm(jc), SV.pcm(tc)
    assert a.shape == b.shape and b.dtype == np.float32
    if a.size:
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    return jc, tc, ts


@pytest.mark.parametrize("cqpsk", [False, True], ids=["c4fm", "cqpsk"])
def test_p25_call(cqpsk):
    tv = SV.vector()
    x = SV.p25_iq(tv, P25_SYM, cqpsk=cqpsk)
    jc, tc, ts = _both(x, "p25p1", cqpsk=cqpsk)
    got = SV.judge_p25(tv, tc, ts, P25_SYM)
    assert got["ldus"] >= 20 and got["keyed_ldus"] >= 8
    assert np.abs(SV.pcm(tc)).max() > 0.05


@pytest.mark.parametrize("force", [None, True, False])
def test_p25_inverted_channel(force):
    tv = SV.vector()
    x = SV.p25_iq(tv, P25_SYM // 2, invert=True)
    attrs = None if force is None else {"force_polarity": {"p25p1": force}}
    jc, tc, ts = _both(x, "p25p1", state_attrs=attrs)
    if force is False:
        # an expectation of normal polarity drops every inverted hit
        assert not tc.events
    else:
        assert tc.events[0].line.startswith("Sync: -P25p1")
        assert SV.judge_p25(tv, tc, ts, P25_SYM // 2)["ldus"] >= 8


@pytest.mark.parametrize("mode", ["provoice", "edacs"])
def test_edacs_provoice(mode):
    tv = SV.vector()
    x = SV.pv_iq(tv, PV_SYM)
    jc, tc, _ts = _both(x, mode)
    got = SV.judge_pv(tv, tc, PV_SYM)
    assert got["edacs_frames"] >= 70 and got["provoice_superframes"] >= 15


def test_edacs_provoice_inverted():
    tv = SV.vector()
    x = SV.pv_iq(tv, PV_SYM // 2, invert=True)
    jc, tc, _ts = _both(x, "provoice")
    assert any(e.line.startswith("Sync: -ProVoice") for e in tc.events)


@pytest.mark.parametrize("env", [{"DSD_NEO_WINDOW_FREEZE": "1"},
                                 {"DSD_NEO_CHANNEL_LPF": "0"}],
                         ids=["freeze", "no_lpf"])
def test_environment_branches(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tv = SV.vector()
    x = SV.p25_iq(tv, P25_SYM // 2)
    jd, js = jdemod.demod_fm(x, "p25p1")
    td, ts = tdemod.demod_fm(x, "p25p1", device="cpu")
    cfg = tcfg.get()
    assert (cfg.window_freeze, cfg.channel_lpf) == (
        jcfg.get().window_freeze, jcfg.get().channel_lpf)
    assert cfg.window_freeze or not cfg.channel_lpf
    off = np.min(np.abs(np.abs(js)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    np.testing.assert_array_equal(jd[off], td[off])
    assert np.abs(js - ts).max() <= SOFT_TOL
    jc, tc, ts_ = _both(x, "p25p1")
    if cfg.channel_lpf:
        assert SV.judge_p25(tv, tc, ts_, P25_SYM // 2)["ldus"] >= 8
    else:
        # unfiltered, the 30 dB noise flips a few raw voice bits, which
        # the frame ECC corrects: the LDUs are all there
        assert sum("VOICE" in e.line for e in tc.events) >= 8


def test_cqpsk_knobs(monkeypatch):
    """``DSD_NEO_COSTAS_DAMPING`` (the carried estimate, ``_cfo_ema``),
    ``DSD_NEO_TED_GAIN``, ``DSD_NEO_COSTAS_BW`` and the window count
    through the environment; the carried estimate equal after each of
    two decodes."""
    monkeypatch.setenv("DSD_NEO_COSTAS_DAMPING", "1.5")
    monkeypatch.setenv("DSD_NEO_TED_GAIN", "1.3")
    monkeypatch.setenv("DSD_NEO_COSTAS_BW", "0.03")
    monkeypatch.delattr(jdemod.demod_cqpsk_path, "_cfo_ema", raising=False)
    monkeypatch.delattr(tdemod.demod_cqpsk_path, "_cfo_ema", raising=False)
    tv = SV.vector()
    x = SV.p25_iq(tv, P25_SYM // 2, cqpsk=True)
    for _ in range(2):
        _both(x, "p25p1", cqpsk=True)
        assert (jdemod.demod_cqpsk_path._cfo_ema
                == tdemod.demod_cqpsk_path._cfo_ema)
    monkeypatch.setenv("DSD_NEO_CFO_WINDOWS", "3")
    monkeypatch.setattr(jcfg, "_config", None)
    monkeypatch.setattr(tcfg, "_config", None)
    jd, js = jdemod.demod_cqpsk_path(x, "p25p1")
    td, ts = tdemod.demod_cqpsk_path(x, "p25p1", device="cpu")
    off = np.min(np.abs(np.abs(js)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    np.testing.assert_array_equal(jd[off], td[off])


def test_recover_symbols_fixed_bit_for_bit():
    rng = np.random.default_rng(31)
    fixed = jax.jit(jtiming.recover_symbols_fixed,
                    static_argnames=("sps", "win_symbols", "max_symbols"))
    for sps, n in ((10.0, 40000), (5.0, 30001), (48000 / 2400, 50000)):
        d = rng.normal(size=(3, n)).astype(np.float32)
        k = int((n - 2 * sps) // sps)
        a, pa = fixed(jax.numpy.asarray(d), sps=sps, max_symbols=k)
        b, pb = ttiming.recover_symbols_fixed(torch.from_numpy(d), sps,
                                              max_symbols=k)
        np.testing.assert_array_equal(np.asarray(pa), pb.numpy())
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sync_hunt():
    tv = SV.vector()
    rng = np.random.default_rng(32)
    for protos in ({"p25p1"}, {"edacs", "provoice"}, None):
        jd, td = jfs.patterns_for(protos), tfs.patterns_for(protos)
        assert [d.name for d in jd] == [d.name for d in td]
        dib = tv["p25_dibits" if protos == {"p25p1"} else "pv_dibits"][:6000]
        soft = (np.where(dib & 2, -1.0, 1.0) * np.where(dib & 1, 3.0, 1.0)
                + rng.normal(0, 0.8, len(dib))).astype(np.float32)
        np.testing.assert_array_equal(jfs.correlate_syncs(soft, jd),
                                      tfs.correlate_syncs(soft, td))
        for thr in (0.62, 0.7, 0.9):
            a = jfs.find_syncs(soft, jd, threshold=thr)
            b = tfs.find_syncs(soft, td, threshold=thr)
            assert [(h.pos, h.score, h.sync.name) for h in a] == [
                (h.pos, h.score, h.sync.name) for h in b]
            assert len(b) > 0
    for jd, td in zip(jfs.SYNC_DEFS, tfs.SYNC_DEFS):
        jt, tt = jfs.polarity_twin(jd), tfs.polarity_twin(td)
        assert (jt and jt.name) == (tt and tt.name)


def test_demod_disc():
    tv = SV.vector()
    dib = tv["p25_dibits"][:9600]
    lv = np.where(dib & 2, -1.0, 1.0) * np.where(dib & 1, 3.0, 1.0)
    d = (np.repeat(lv, 10) * 0.1
         + np.random.default_rng(33).normal(0, 0.01, 96000)
         ).astype(np.float32)
    jd, js = jdemod.demod_disc(d, "p25p1")
    td, ts = tdemod.demod_disc(d, "p25p1", device="cpu")
    off = np.min(np.abs(np.abs(js)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    assert off.mean() > 0.95
    np.testing.assert_array_equal(jd[off], td[off])


def test_mode_table():
    assert list(tmodes.MODES) == list(jmodes.MODES)
    for name, j in jmodes.MODES.items():
        t = tmodes.MODES[name]
        assert (t.name, t.flag, t.lpf_profile, t.symbol_rate, t.four_level,
                t.protocols, t.sps) == (j.name, j.flag, j.lpf_profile,
                                        j.symbol_rate, j.four_level,
                                        j.protocols, j.sps)
    assert tmodes.FLAG_TO_MODE == jmodes.FLAG_TO_MODE


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = SV.p25_iq(SV.vector(), 2000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.decode_samples(x, "p25p1")
    for fn in (tdemod.demod_fm, tdemod.demod_cqpsk_path):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x, "p25p1")
