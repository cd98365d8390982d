"""The YSF V/D2 voice path of the PyTorch port against the JAX package's
(``engine/ysfbatch.py``), on the CPU.

  - the tables: the V/D2 offsets, the de-interleave gather and the PN95
    mask equal the JAX package's, the ``+YSF`` row and the mode's;
  - ``ysf_voice_decode_gather`` on random dibits at chosen frame
    positions, with clean V/D2 frames among them and a pad frame: the
    voted bits and vote counts equal the JAX package's gather (its
    tables and its vote, in numpy: the JAX function returns only the
    PCM), the PCM (f16, atol 2e-4 of the peak, rtol 2^-10) and the
    carries (rtol 1e-5) equal the JAX function's;
  - the pipeline on the stream of ``data/burst_tables.npz`` at C = 3,
    two 1.5 s blocks with the carry kept, f16 and adpcm: the candidates,
    the accepted frames, the voted bits and vote counts
    (``decode_block_bits49`` of both) equal, the PCM within the bounds of
    ``tests/test_torch_x2.py`` and the carries within rtol 1e-5; every
    channel holds the vector's frames (``protocol.ysf.encode.judge``).

The JAX functions are jitted, as its pipelines call them.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from dsdneo_tpu.engine import modes as jmodes  # noqa: E402
from dsdneo_tpu.engine import ysfbatch as J  # noqa: E402
from dsdneo_tpu.engine.voicebatch import _sync_kernel  # noqa: E402
from dsdneo_tpu.protocol.ysf import decoder as jdec  # noqa: E402
from dsdneo_tpu_torch import params  # noqa: E402
from dsdneo_tpu_torch.engine import ysfbatch as P  # noqa: E402
from dsdneo_tpu_torch.engine.modes import MODES  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr.encode import vector_block  # noqa: E402
from dsdneo_tpu_torch.protocol.ysf import encode as ysf_encode  # noqa: E402
from dsdneo_tpu_torch.symbols.framesync import sync_levels  # noqa: E402

import export_torch_tables as X  # noqa: E402
from test_torch_x2 import assert_pcm_matches  # noqa: E402

BLOCK_DIBITS = 7200                 # 1.5 s at 4800 baud
LEADS = (0, 41, 96)


@pytest.fixture(scope="module")
def tables():
    return params.load_burst("ysf", "cpu")


def test_tables_equal_the_jax_constants():
    for a, b in zip(P._vd2_tables(), J._vd2_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.pn95_bits(512), jdec._PN95_512)
    np.testing.assert_array_equal(sync_levels(P.BatchedYsfVoicePipeline.
                                              SYNC_NAMES),
                                  _sync_kernel(("+YSF",))[1][:, 0])
    m, jm = MODES["ysf"], jmodes.MODES["ysf"]
    assert (m.lpf_profile, m.symbol_rate, m.four_level) == (
        jm.lpf_profile, jm.symbol_rate, jm.four_level)
    assert (P.FRAME_DIBITS, P.VOTE_ERR_MAX) == (J.FRAME_DIBITS,
                                                J.VOTE_ERR_MAX)


def jax_bits(dib, ac, at):
    """The JAX gather's voted bits and vote counts: its tables, its
    clipping and its majority vote, in numpy (its device program returns
    only the PCM)."""
    offs, inv, pn = J._vd2_tables()
    dib = np.asarray(dib)
    ch = np.minimum(ac, dib.shape[0] - 1)
    pos = np.clip(np.asarray(at)[:, None, None] + offs[None], 0,
                  dib.shape[1] - 1)
    dd = dib[ch[:, None, None], pos].reshape(-1, 52)
    raw = np.stack([(dd >> 1) & 1, dd & 1], -1).reshape(-1, 104)
    bits = raw[:, inv] ^ pn
    s = bits[:, :81].reshape(-1, 27, 3).sum(-1)
    return (np.concatenate([(s >= 2), bits[:, 81:103]], 1).astype(np.uint8),
            ((s != 0) & (s != 3)).sum(-1))


def test_voice_decode_gather_matches(tables):
    """Random dibits with 4 clean V/D2 frames among 9 (one more a pad):
    bits and vote counts to the bit, the clean frames with their 49 bits
    and no vote error, the PCM and the carries as stated."""
    rng = np.random.default_rng(5)
    Cx, Tn = 3, 3000
    dib = rng.integers(0, 4, (Cx, Tn)).astype(np.uint8)
    f_ch = np.array([0, 0, 1, 1, 1, 2, 2, 2, 2, Cx])
    f_pos = np.array([0, 1100, 30, 900, 2520, 7, 600, 1300, 2600, 0])
    clean = {1: None, 3: None, 6: None, 7: None}
    offs = P._vd2_tables()[0]
    for f in clean:
        b49 = rng.integers(0, 2, (5, 49)).astype(np.uint8)
        for blk in range(5):
            dib[f_ch[f], f_pos[f] + offs[blk]] = X._ysf_vd2_dibits(
                b49[blk], blk & 1)
        clean[f] = b49
    fch = np.repeat(f_ch, 5)
    rank = np.concatenate([np.arange(n) for n in np.bincount(f_ch)])
    forder = (5 * rank[:, None] + np.arange(5)).reshape(-1)
    n_steps = 20
    jw, jst = J.ysf_voice_decode_gather(
        jnp.asarray(dib), jnp.asarray(f_ch.astype(np.int32)),
        jnp.asarray(f_pos.astype(np.int32)),
        jnp.asarray(fch.astype(np.int32)),
        jnp.asarray(forder.astype(np.int32)), Cx, n_steps)
    out = P.ysf_voice_decode_gather(
        torch.as_tensor(dib), torch.as_tensor(f_ch), torch.as_tensor(f_pos),
        torch.as_tensor(fch), torch.as_tensor(forder), Cx, n_steps,
        tables.ambe)
    jb, je = jax_bits(dib, f_ch, f_pos)
    np.testing.assert_array_equal(out.bits49.numpy(), jb)
    np.testing.assert_array_equal(out.errs.numpy(), je)
    for f, b49 in clean.items():
        np.testing.assert_array_equal(out.bits49.numpy()[5 * f:5 * f + 5],
                                      b49)
        assert not out.errs.numpy()[5 * f:5 * f + 5].any()
    assert (je.reshape(-1, 5)[[0, 2, 4, 5, 8]] > P.VOTE_ERR_MAX).all()
    jw, tw = np.asarray(jw).astype(np.float32), out.pcm.numpy().astype(
        np.float32)
    assert tw.shape == jw.shape == (Cx, n_steps, 160)
    peak = np.abs(jw).max()
    assert peak > 0
    np.testing.assert_allclose(tw, jw, atol=2e-4 * peak, rtol=2.0 ** -10)
    flat = [a for part in jst for a in part]
    tflat = [a for part in out.state for a in part]
    for i, (a, b) in enumerate(zip(tflat, flat)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=0, err_msg=str(i))


def _blocks(tv, leads, seed):
    """Two consecutive 1.5 s blocks of the stream per channel (the second
    starts where the first ends), own lead and noise per channel."""
    out = []
    for b in range(2):
        tvb = dict(tv, dibits=tv["dibits"][b * BLOCK_DIBITS:])
        if b:
            tvb["lead"] = np.concatenate([tv["lead"], tv["dibits"]])[
                :b * BLOCK_DIBITS + len(tv["lead"])]
        out.append(vector_block(tvb, leads, seed + 10 * b
                                + np.arange(len(leads)), BLOCK_DIBITS * 10,
                                modulate=ysf_encode.fm_iq,
                                lead_dibits=tvb["lead"]))
    return out


@pytest.fixture(scope="module", params=["f16", "adpcm"])
def runs(request, tables):
    """Two blocks with the carry kept, in both pipelines."""
    fmt = request.param
    xs = _blocks(tables.test_vector(), LEADS, 30)
    C = len(LEADS)
    jp = J.BatchedYsfVoicePipeline(C, pcm_fmt=fmt)
    tp = P.BatchedYsfVoicePipeline(C, pcm_fmt=fmt, device="cpu",
                                   tables=tables)
    out = {"fmt": fmt}
    for blk, x in enumerate(xs):
        jfe = jp.frontend_sync_device(jnp.asarray(x))
        tfe = tp.frontend_sync_device(torch.as_tensor(x))
        out["fe", blk] = (jfe, tfe)
        out["picks", blk] = (jp.pick_frames(*jfe[1:]),
                             tp.pick_frames(*tfe[1:]))
        if fmt == "f16":
            out["bits", blk] = (jp.decode_block_bits49(jnp.asarray(x)),
                                tp.decode_block_bits49(torch.as_tensor(x)))
        jh = jp.decode_from_frontend(jfe)
        th = tp.decode_from_frontend(tfe)
        out["wire", blk] = (np.asarray(jh), th.numpy())
        out["pcm", blk] = (jp.fetch_pcm(jh), tp.fetch_pcm(th))
        out["state", blk] = (jp._vstate, tp._vstate)
        out["frames", blk] = tp.last_frames
    return out


@pytest.mark.parametrize("blk", [0, 1])
def test_pipeline_frames_pcm_and_carries(runs, tables, blk):
    jfe, tfe = runs["fe", blk]
    assert jfe[3] == tfe[3] == BLOCK_DIBITS - 2
    np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
    np.testing.assert_array_equal(np.sort(tfe[1], 1), np.sort(jfe[1], 1))
    for a, b in zip(*runs["picks", blk]):
        np.testing.assert_array_equal(a, b)
    ac, at, _fch, _ford = runs["picks", blk][1]
    bits, verr, fch, _forder, _acc = runs["frames", blk]
    if runs["fmt"] == "f16":
        (jb, je), (tb, te) = runs["bits", blk]
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(bits.numpy(), jb)
    tv = tables.test_vector()
    tvb = dict(tv, starts=tv["starts"] - blk * BLOCK_DIBITS)
    b5, e5 = bits.numpy().reshape(-1, 5, 49), verr.numpy().reshape(-1, 5)
    n_voice = 0
    for c, lead in enumerate(LEADS):
        n_voice += ysf_encode.judge(tvb, lead, BLOCK_DIBITS - 2,
                                    [(int(t), b5[h], e5[h]) for h, t in
                                     enumerate(at) if ac[h] == c])
    assert n_voice >= 3 * 8
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
    """``BatchedYsfVoicePipeline`` with no device runs on the card and
    raises where there is none; it refuses another kind's tables."""
    if torch.cuda.is_available():
        assert P.BatchedYsfVoicePipeline(1).taps.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.BatchedYsfVoicePipeline(1)
    with pytest.raises(ValueError, match="tables of 'dpmr'"):
        P.BatchedYsfVoicePipeline(1, device="cpu",
                                  tables=params.load_burst("dpmr", "cpu"))
