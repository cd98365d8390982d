"""The per-shard bodies of ``parallel/mesh.py`` in the PyTorch port
against the JAX package's, on the CPU, at C=4 channels of real signals:
each channel its own lead and noise.

  - P25p1 voice and control channel: the JAX generators
    (``protocol/p25/encode``: LDUs of random IMBE frames, TSDUs with an
    IDEN_UP, a group grant and NET_STS);
  - DMR voice: ``engine/dmrbatch.synth_voice_stream``; DMR control
    channel: a TSCC of TV_GRANT and C_ALOHA CSBKs
    (``protocol/dmr/encode``);
  - P25p2 voice: ``engine/p2batch.synth_p2_voice_stream`` through the
    port's TDMA modulator;
  - NXDN48 voice and RCCH, EDACS CC: the streams of the port's
    ``data/fleet_tables.npz``; analog voice: a 1 kHz NBFM tone.

Blobs, valid masks, meta and pick decisions must be equal bit for bit.
PCM: f16 wire values within 2e-3 of the peak for IMBE (as
``test_torch_voicebatch.py`` holds the P25 voice path), 2e-4 of the peak
plus one float16 step for AMBE (as ``test_torch_dmrbatch.py``), the
analog rows within 1e-4 of the peak.  The JAX body runs inside
``jax.jit``; the P25 voice body, which calls ``pcast``, under
``shard_map`` on a one-device mesh.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")     # the card's machine has none

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, PartitionSpec as JP  # noqa: E402

from dsdneo_tpu.parallel import mesh as JM  # noqa: E402
from dsdneo_tpu_torch import params  # noqa: E402
from dsdneo_tpu_torch.engine import fleetvec as FV  # noqa: E402
from dsdneo_tpu_torch.parallel import mesh as PM  # noqa: E402

C = 4
FS = 48000.0


def planes(x: np.ndarray) -> np.ndarray:
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def channels(make, n: int, seed: int) -> np.ndarray:
    """``[C, n, 2]`` planes: channel c is ``make(lead_c, seed + c)``,
    cut or padded to n samples."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(C):
        x = make(int(rng.integers(0, 97)), seed + c)[:n]
        x = np.concatenate([x, np.zeros(n - len(x), x.dtype)])
        out.append(planes(x))
    return np.stack(out)


def lead(k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, k).astype(np.uint8)


def p25_voice(k: int, seed: int) -> np.ndarray:
    from dsdneo_tpu.protocol.p25 import encode as E
    ldus = E.random_voice_ldus(5, seed=seed)
    dib = [lead(30 + k, seed)] + [
        E.ldu_frame(0x293, ldus[i], duid=5 if i % 2 == 0 else 10, seed=i)
        for i in range(5)]
    return E.c4fm_iq(np.concatenate(dib), sps=10, fs=FS, seed=seed)


def p25_cc(k: int, seed: int) -> np.ndarray:
    from dsdneo_tpu.protocol.p25 import encode as E
    iden = E.iden_up_tsbk(1, 851e6, 3000.0)
    netstat = E.tsbk_bytes(0x3B, [0, 0x92, 0x06, 0x50, 0xD5, 0, 0, 0],
                           lb=True)
    frame = E.tsdu_frame(0x293, [iden, E.group_grant_tsbk(
        (1 << 12) | 16, tg=101 + seed, src=1000), netstat])
    dib = [lead(60 + k, seed)]
    for _ in range(12):
        dib += [frame, lead(24, seed + 1)]
    return E.c4fm_iq(np.concatenate(dib), sps=10, fs=FS, seed=seed)


def dmr_voice(k: int, seed: int) -> np.ndarray:
    from dsdneo_tpu.engine.dmrbatch import synth_voice_stream
    from dsdneo_tpu.protocol.p25.encode import c4fm_iq
    _iq, dib, _bits = synth_voice_stream(n_superframes=3, seed=seed)
    return c4fm_iq(np.concatenate([lead(k, seed), dib]), sps=10, fs=FS,
                   seed=seed)


def dmr_cc(k: int, seed: int) -> np.ndarray:
    from dsdneo_tpu.protocol.dmr import encode as DE
    from dsdneo_tpu.protocol.p25.encode import c4fm_iq
    grant = DE.tv_grant_csbk(lpcn=24, ts=0, tg=101 + seed, src=1000)
    idle = DE.csbk_bits(25, 0, bytes(8))
    dib = DE.cc_stream_dibits([grant if i % 3 == 0 else idle
                               for i in range(36)], cc=1, seed=seed)
    return c4fm_iq(np.concatenate([lead(k, seed), dib]), sps=10, fs=FS,
                   seed=seed)


def p2_voice(k: int, seed: int) -> np.ndarray:
    from dsdneo_tpu.engine.p2batch import synth_p2_voice_stream
    from dsdneo_tpu_torch.protocol.p25.encode import tdma_fm_iq
    _iq, dib, _bits = synth_p2_voice_stream(n_superframes=3, seed=seed)
    return FV._noisy(tdma_fm_iq(np.concatenate([lead(k, seed), dib]), 8),
                     seed)


def nxdn(kind: str):
    def make(k: int, seed: int) -> np.ndarray:
        from dsdneo_tpu_torch.protocol.nxdn import encode as NE
        dib = FV.vector()[f"nxdn_{kind}_dibits"]
        x = NE.modulator("nxdn48")(np.concatenate([lead(k, seed), dib]), 20)
        return FV._noisy(x, seed)
    return make


def edacs_cc(k: int, seed: int) -> np.ndarray:
    from dsdneo_tpu_torch.protocol.edacs import encode as EE
    dib = FV.vector()["edacs_cc_dibits"]
    return FV._noisy(EE.fm_iq(np.concatenate([lead(k, seed), dib])), seed)


def tone(k: int, seed: int) -> np.ndarray:
    t = np.arange(int(FS)) / FS
    x = np.exp(1j * 2 * np.pi * 2500.0 * np.cumsum(
        np.sin(2 * np.pi * (1000.0 + 50 * seed) * t)) / FS)
    x[:k * 100] = 0
    return FV._noisy(x, seed)


def run_jax(body, iq, pcast: bool = False):
    if pcast:
        from jax import shard_map
        mesh = JMesh(np.array(jax.devices()[:1]), axis_names=("ch",))
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=JP("ch", None, None),
                              out_specs=(JP("ch", None), JP("ch"))))
    else:
        f = jax.jit(body)
    return [np.asarray(a) for a in f(jnp.asarray(iq))]


def run_port(body, iq):
    return [a.numpy() for a in body(torch.as_tensor(iq))]


def pcm_close(a, b, rel: float, f16: bool = True):
    peak = float(np.abs(a).max())
    assert a.shape == b.shape and peak > 0 and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=rel * peak,
                               rtol=2.0 ** -10 if f16 else 0)


@pytest.fixture(scope="module")
def tables():
    return {"p25": params.load("cpu"), "dmr": params.load_dmr("cpu"),
            "p2": params.load_tdma("p25p2", "cpu"),
            "nxdn": params.load_tdma("nxdn48", "cpu"),
            "cc_p25": params.load_cc("p25", "cpu"),
            "cc_dmr": params.load_cc("dmr", "cpu"),
            "cc_nxdn": params.load_cc("nxdn48", "cpu")}


def test_p25_voice_body(tables):
    B = 48000
    iq = channels(p25_voice, B, 10)
    jp, jpow = run_jax(JM._p25_voice_body(C, B, FS, 4), iq, pcast=True)
    pp, ppow = run_port(PM._p25_voice_body(C, B, FS, 4,
                                           tables=tables["p25"]), iq)
    pcm_close(jp.astype(np.float32), pp, 2e-3)
    np.testing.assert_allclose(ppow, jpow, rtol=1e-6)
    # every channel decodes its LDUs
    assert (np.abs(pp).max(axis=1) > 1e-3).all()


def test_dmr_voice_body(tables):
    B = int(FS * 1.2)
    iq = channels(dmr_voice, B, 20)
    jp, jpow = run_jax(JM._dmr_voice_body(C, B, FS, 2), iq)
    pp, ppow = run_port(PM._dmr_voice_body(C, B, FS, 2,
                                           tables=tables["dmr"]), iq)
    pcm_close(jp, pp, 2e-4)
    np.testing.assert_allclose(ppow, jpow, rtol=1e-6)
    assert (np.abs(pp).max(axis=1) > 1e-3).all()


def test_dmr_cc_body(tables):
    B = int(FS * 1.0)
    iq = channels(dmr_cc, B, 30)
    jout = run_jax(JM._dmr_cc_body(C, B, FS, 8), iq)
    pout = run_port(PM._dmr_cc_body(C, B, FS, 8, tables=tables["cc_dmr"]),
                    iq)
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(b, a)
    assert pout[1].sum(axis=1).min() >= 2          # CSBKs on every channel
    assert (pout[0][pout[1]][:, 12] == 1).all()    # CRC-valid


def test_nxdn_voice_body(tables):
    B = int(FS * 1.0)
    iq = channels(nxdn("vc"), B, 40)
    jp, jpow = run_jax(JM._nxdn_voice_body(C, B, FS, 4), iq)
    pp, ppow = run_port(PM._nxdn_voice_body(C, B, FS, 4,
                                            tables=tables["nxdn"]), iq)
    pcm_close(jp, pp, 2e-4)
    np.testing.assert_allclose(ppow, jpow, rtol=1e-6)
    assert (np.abs(pp).max(axis=1) > 1e-3).all()


def test_nxdn_cc_body(tables):
    B = int(FS * 1.0)
    iq = channels(nxdn("cc"), B, 50)
    jout = run_jax(JM._nxdn_cc_body(C, B, FS, 8), iq)
    pout = run_port(PM._nxdn_cc_body(C, B, FS, 8, tables=tables["cc_nxdn"]),
                    iq)
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(b, a)
    assert pout[1].sum(axis=1).min() >= 1
    assert (pout[0][pout[1]][:, 22] == 1).all()


def test_edacs_cc_body():
    B = int(FS * 1.0)
    iq = channels(edacs_cc, B, 60)
    jout = run_jax(JM._edacs_cc_body(C, B, FS, 8), iq)
    pout = run_port(PM._edacs_cc_body(C, B, FS, 8, device="cpu"), iq)
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(b, a)
    assert pout[1].sum(axis=1).min() >= 4
    assert (pout[0][pout[1]][:, 8] == 1).all()


def test_analog_voice_body():
    B = int(FS * 1.0)
    iq = channels(tone, B, 70)
    jp, jpow = run_jax(JM._analog_voice_body(FS), iq)
    pp, ppow = run_port(PM._analog_voice_body(FS), iq)
    pcm_close(jp, pp, 1e-4, f16=False)
    np.testing.assert_allclose(ppow, jpow, rtol=1e-6)


def test_p2_voice_body(tables):
    B = int(FS * 1.2)
    iq = channels(p2_voice, B, 80)
    jp, jpow = run_jax(JM._p2_voice_body(C, B, FS, 8), iq)
    pp, ppow = run_port(PM._p2_voice_body(C, B, FS, 8,
                                          tables=tables["p2"]), iq)
    assert pp.shape[0] == 2 * C
    pcm_close(jp, pp, 2e-4)
    np.testing.assert_allclose(ppow, jpow, rtol=1e-6)
    assert (np.abs(pp).max(axis=1) > 1e-3).all()   # both slots


@pytest.mark.parametrize("nac_out, dedup", [(False, False), (True, True)])
def test_p25_cc_body(tables, nac_out, dedup):
    B = int(FS * 1.0)
    iq = channels(p25_cc, B, 90)
    jout = run_jax(JM._p25_cc_body(C, B, FS, 8, nac_out=nac_out,
                                   dedup=dedup), iq)
    pout = run_port(PM._p25_cc_body(C, B, FS, 8, nac_out=nac_out,
                                    dedup=dedup, tables=tables["cc_p25"]),
                    iq)
    assert len(pout) == len(jout)
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(b, a)
    valid = pout[1]
    assert valid.sum(axis=1).min() >= 2
    assert (pout[0][valid][:, [12, 50, 88]] == 1).all()


def test_shoulder_mask():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 60, size=(5, 7, 8))
    want = np.asarray(JM._topk_shoulder_mask(jnp.asarray(idx)))
    got = PM._topk_shoulder_mask(torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_body_refuses_another_shape(tables):
    body = PM._p25_voice_body(2, 4800, tables=tables["p25"])
    with pytest.raises(ValueError):
        body(torch.zeros((3, 4800, 2)))


@pytest.mark.parametrize("mode", ["nxdn48", "edacs"])
def test_cc_bodies_parse_no_frame_twice(tables, mode):
    """The NXDN and EDACS CC bodies keep the JAX package's 8-position
    shoulder mask (their blobs stay equal to its), which lets a frame
    through twice only where a second candidate within one frame's
    extent (192 dibits, 288 for EDACS) passes the gates.  On the fleet
    vectors' control channels (``engine/fleetvec``, both 1 s blocks of
    the 768 kHz band, 16 candidates): no such pair, and the blobs and
    masks equal the JAX body's."""
    from dsdneo_tpu_torch.engine.fleettrunk import make_row_extractor_body
    tv = FV.vector()
    band = (FV.nxdn_band if mode == "nxdn48" else FV.edacs_band)(tv)
    cc_off = int(tv[f"{'nxdn' if mode == 'nxdn48' else mode}_offs"][0])
    ex = make_row_extractor_body(16)
    nb = int(FV.MODE_FS)
    extent = 192 if mode == "nxdn48" else 288
    for i in range(2):
        rows = ex(band[i * nb:(i + 1) * nb],
                  torch.tensor([cc_off], dtype=torch.int32))
        iq = torch.view_as_real(rows).contiguous().numpy()
        Bp = iq.shape[1]
        if mode == "nxdn48":
            jb = JM._nxdn_cc_body(1, Bp, FS, 16, 0.55)
            pb = PM._nxdn_cc_body(1, Bp, FS, 16, 0.55,
                                  tables=tables["cc_nxdn"])
        else:
            jb = JM._edacs_cc_body(1, Bp, FS, 16)
            pb = PM._edacs_cc_body(1, Bp, FS, 16, device="cpu")
        for a, b in zip(run_jax(jb, iq), run_port(pb, iq)):
            np.testing.assert_array_equal(b, a)
        pos = pb.positions[0][pb.picks[0]].numpy()
        d = np.abs(pos[:, None] - pos[None, :])
        assert pos.size >= 8
        assert not ((d > 0) & (d < extent)).any()
