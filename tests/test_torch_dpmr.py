"""The dPMR voice path of the PyTorch port against the JAX package's
(``engine/dpmrbatch.py``), on the CPU.

  - the tables: the part's voice offsets, the ``±dPMR FS2`` rows and the
    mode equal the JAX package's;
  - the device program (``nxdn_voice_decode_gather`` with dPMR's offsets
    and a zero flip mask) on random dibits at chosen part positions, some
    parts inverted and some clean (``encode_ambe_ecc`` frames), a pad
    part among them: bits and ECC error counts equal the JAX package's
    gather through its AMBE ECC, the PCM (f16: atol 2e-4 of the peak,
    rtol 2^-10) and the carries (rtol 1e-5) equal the JAX function's;
  - the pipeline on the stream of ``data/burst_tables.npz`` at C = 3
    (channel 2 inverted), two 1.5 s blocks with the carry kept, f16 and
    adpcm: the candidates (position, score, pattern), the accepted parts
    with their polarity, the bits and error counts equal, the PCM within
    the bounds of ``tests/test_torch_x2.py`` and the carries within rtol
    1e-5; every channel holds the vector's parts
    (``protocol.dpmr.encode.judge``).

The JAX functions are jitted, as its pipelines call them.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none
jnp = jax.numpy

from dsdneo_tpu.engine import dpmrbatch as J  # noqa: E402
from dsdneo_tpu.engine import modes as jmodes  # noqa: E402
from dsdneo_tpu.engine.nxdnbatch import nxdn_voice_decode_gather  # noqa
from dsdneo_tpu.engine.voicebatch import _sync_kernel  # noqa: E402
from dsdneo_tpu.fec import device as jfec  # noqa: E402
from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc  # noqa
from dsdneo_tpu_torch import params  # noqa: E402
from dsdneo_tpu_torch.engine import dpmrbatch as P  # noqa: E402
from dsdneo_tpu_torch.engine import nxdnbatch as tnx  # noqa: E402
from dsdneo_tpu_torch.engine.modes import MODES  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr.encode import vector_block  # noqa: E402
from dsdneo_tpu_torch.protocol.dpmr import encode as dpmr_encode  # noqa
from dsdneo_tpu_torch.symbols.framesync import sync_levels  # noqa: E402

from test_torch_x2 import assert_pcm_matches  # noqa: E402

BLOCK_DIBITS = 3600                 # 1.5 s at 2400 baud
LEADS = (0, 41, 96)                 # channel 2 inverted


@pytest.fixture(scope="module")
def tables():
    return params.load_burst("dpmr", "cpu")


def test_tables_equal_the_jax_constants():
    np.testing.assert_array_equal(P._voice_offsets(), J._voice_offsets())
    names = P.BatchedDpmrVoicePipeline.SYNC_NAMES
    assert names == J.BatchedDpmrVoicePipeline.SYNC_NAMES
    np.testing.assert_array_equal(sync_levels(names),
                                  _sync_kernel(names)[1][:, 0])
    m, jm = MODES["dpmr"], jmodes.MODES["dpmr"]
    assert (m.lpf_profile, m.symbol_rate, m.four_level) == (
        jm.lpf_profile, jm.symbol_rate, jm.four_level)
    assert (P.PART_DIBITS, P.FRAMES_PER_PART) == (J.PART_DIBITS,
                                                  J.FRAMES_PER_PART)


def jax_frames(dib, ac, at, ai):
    """The JAX gather's bits and error counts: its dibits at its offsets,
    polarity flipped on inverted parts, through its AMBE ECC (its device
    program returns only the PCM)."""
    dib = np.asarray(dib)
    ch = np.minimum(ac, dib.shape[0] - 1)
    pos = np.clip(np.asarray(at)[:, None] + J._voice_offsets()[None], 0,
                  dib.shape[1] - 1)
    dd = dib[ch[:, None], pos] ^ (np.asarray(ai)[:, None] * 2).astype(
        np.uint8)
    b72 = np.stack([(dd >> 1) & 1, dd & 1], -1).reshape(-1, 72)
    return tuple(np.asarray(a) for a in jfec.ambe_ecc_batch(
        jnp.asarray(b72.astype(np.uint8))))


def test_voice_decode_gather_matches(tables):
    rng = np.random.default_rng(8)
    Cx, Tn = 3, 2000
    dib = rng.integers(0, 4, (Cx, Tn)).astype(np.uint8)
    f_ch = np.array([0, 0, 1, 1, 2, 2, 2, Cx])
    f_pos = np.array([0, 900, 20, 1610, 5, 700, 1400, 0])
    f_inv = np.array([0, 1, 0, 1, 1, 0, 0, 0])
    offs = P._voice_offsets().reshape(8, 36)
    clean = {}
    for f in (1, 2, 5):
        b49 = rng.integers(0, 2, (8, 49)).astype(np.uint8)
        for k in range(8):
            v = encode_ambe_ecc(b49[k])
            dib[f_ch[f], f_pos[f] + offs[k]] = (
                ((v[0::2] << 1) | v[1::2]) ^ (2 * f_inv[f]))
        clean[f] = b49
    fch = np.repeat(f_ch, 8)
    rank = np.concatenate([np.arange(n) for n in np.bincount(f_ch)])
    forder = (8 * rank[:, None] + np.arange(8)).reshape(-1)
    n_steps = 32
    joffs = jnp.asarray(J._voice_offsets())
    jflips = jnp.zeros(288, jnp.uint8)
    jw, jst = nxdn_voice_decode_gather(
        jnp.asarray(dib), *(jnp.asarray(a.astype(np.int32)) for a in
                            (f_ch, f_pos, f_inv)), joffs, jflips,
        jnp.asarray(fch.astype(np.int32)),
        jnp.asarray(forder.astype(np.int32)), Cx, n_steps)
    out = tnx.nxdn_voice_decode_gather(
        torch.as_tensor(dib), *(torch.as_tensor(a) for a in
                                (f_ch, f_pos, f_inv)),
        torch.as_tensor(P._voice_offsets()),
        torch.zeros(288, dtype=torch.uint8), torch.as_tensor(fch),
        torch.as_tensor(forder), Cx, n_steps, tables.ambe)
    jb, je = jax_frames(dib, f_ch, f_pos, f_inv)
    np.testing.assert_array_equal(out.bits49.numpy(), jb)
    np.testing.assert_array_equal(out.errs.numpy(), je)
    for f, b49 in clean.items():
        np.testing.assert_array_equal(out.bits49.numpy()[8 * f:8 * f + 8],
                                      b49)
        assert not out.errs.numpy()[8 * f:8 * f + 8].any()
    jw, tw = np.asarray(jw).astype(np.float32), out.pcm.numpy().astype(
        np.float32)
    assert tw.shape == jw.shape == (Cx, n_steps, 160)
    peak = np.abs(jw).max()
    assert peak > 0
    np.testing.assert_allclose(tw, jw, atol=2e-4 * peak, rtol=2.0 ** -10)
    for i, (a, b) in enumerate(zip([a for p in out.state for a in p],
                                   [a for p in jst for a in p])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=0, err_msg=str(i))


def _blocks(tv, seed):
    """Two consecutive 1.5 s blocks of the stream per channel (the second
    starts where the first ends), own lead and noise per channel, the
    last channel with the FM negated."""
    out = []
    for b in range(2):
        tvb = dict(tv, dibits=tv["dibits"][b * BLOCK_DIBITS:])
        if b:
            tvb["lead"] = np.concatenate([tv["lead"], tv["dibits"]])[
                :b * BLOCK_DIBITS + len(tv["lead"])]
        out.append(np.concatenate([
            vector_block(tvb, leads, seed + 10 * b + np.arange(len(leads)),
                         BLOCK_DIBITS * 20, sps=20,
                         modulate=dpmr_encode.fm_iq,
                         lead_dibits=tvb["lead"], invert=inv)
            for leads, inv in ((LEADS[:2], False), (LEADS[2:], True))]))
    return out


@pytest.fixture(scope="module", params=["f16", "adpcm"])
def runs(request, tables):
    fmt = request.param
    xs = _blocks(tables.test_vector(), 40)
    C = len(LEADS)
    jp = J.BatchedDpmrVoicePipeline(C, pcm_fmt=fmt)
    tp = P.BatchedDpmrVoicePipeline(C, pcm_fmt=fmt, device="cpu",
                                    tables=tables)
    out = {"fmt": fmt}
    for blk, x in enumerate(xs):
        jfe = jp.frontend_sync_device(jnp.asarray(x))
        tfe = tp.frontend_sync_device(torch.as_tensor(x))
        out["fe", blk] = (jfe, tfe)
        jpick = jp.pick_parts(*jfe[1:])
        out["picks", blk] = (jpick, tp.pick_parts(*tfe[1:]))
        out["jframes", blk] = jax_frames(jfe[0], *jpick[:3])
        jh = jp.decode_from_frontend(jfe)
        th = tp.decode_from_frontend(tfe)
        out["wire", blk] = (np.asarray(jh), th.numpy())
        out["pcm", blk] = (jp.fetch_pcm(jh), tp.fetch_pcm(th))
        out["state", blk] = (jp._vstate, tp._vstate)
        out["frames", blk] = tp.last_frames
    return out


@pytest.mark.parametrize("blk", [0, 1])
def test_pipeline_parts_pcm_and_carries(runs, tables, blk):
    jfe, tfe = runs["fe", blk]
    assert jfe[4] == tfe[4] == BLOCK_DIBITS - 2
    np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
    jo, to = np.argsort(jfe[1], 1, kind="stable"), np.argsort(
        tfe[1], 1, kind="stable")
    for a, b in zip(tfe[1:4], jfe[1:4]):
        np.testing.assert_array_equal(np.take_along_axis(np.asarray(a), to,
                                                         1),
                                      np.take_along_axis(np.asarray(b), jo,
                                                         1))
    for a, b in zip(*runs["picks", blk]):
        np.testing.assert_array_equal(a, b)
    ac, at, ai, _fch, _ford = runs["picks", blk][1]
    bits, errs, _fch, _forder, _acc = runs["frames", blk]
    jb, je = runs["jframes", blk]
    np.testing.assert_array_equal(bits.numpy(), jb)
    np.testing.assert_array_equal(errs.numpy(), je)
    tv = tables.test_vector()
    tvb = dict(tv, starts=tv["starts"] - blk * BLOCK_DIBITS)
    b8, e8 = bits.numpy().reshape(-1, 8, 49), errs.numpy().reshape(-1, 8)
    n = 0
    for c, lead in enumerate(LEADS):
        n += dpmr_encode.judge(tvb, lead, BLOCK_DIBITS - 2,
                               [(int(t), int(ai[h]), b8[h], e8[h])
                                for h, t in enumerate(at) if ac[h] == c],
                               inverted=c == 2)
    assert n >= 3 * 3
    (jw, tw), (jpcm, tpcm) = runs["wire", blk], runs["pcm", blk]
    assert tpcm.shape == jpcm.shape and tpcm.shape[0] == len(LEADS)
    assert_pcm_matches(runs["fmt"], tpcm, jpcm, tw, jw)
    js, ts = runs["state", blk]
    flat = lambda st: [a.numpy() if torch.is_tensor(a) else np.asarray(a)
                       for part in st for a in part]
    for i, (a, b) in enumerate(zip(flat(ts), flat(js))):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=str(i))


def test_entry_point_takes_the_card():
    """``BatchedDpmrVoicePipeline`` with no device runs on the card and
    raises where there is none; ``params.load_burst`` likewise."""
    if torch.cuda.is_available():
        assert P.BatchedDpmrVoicePipeline(1).taps.is_cuda
        assert params.load_burst("dpmr").ambe.adpcm_step.is_cuda
    else:
        for make in (lambda: P.BatchedDpmrVoicePipeline(1),
                     lambda: params.load_burst("dpmr")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    with pytest.raises(ValueError, match="unknown burst path"):
        params.load_burst("provoice", "cpu")
