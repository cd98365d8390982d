"""The EDACS control-channel monitor of the PyTorch port against the JAX
package's (``engine/ccbatch.py``, ``protocol/edacs``), on the CPU.

  - the host catalog: the BCH(40,28) generator and parity rows,
    ``edacs_bch_encode``, and the standard and EA catalogs' lines and
    events (fields included) on the stream's messages and on random
    pairs, and the AFS split, equal the JAX package's;
  - ``edacs_cc_decode_device`` on random dibits at chosen positions with
    clean, inverted and corrupted frames among them, a pad hit too: the
    blob equals the JAX function's byte for byte;
  - the monitor on the stream of ``data/burst_tables.npz``, two
    consecutive 1 s blocks with the contexts kept, four channels read
    in the standard, EA and ESK modes and one inverted: the accepted
    frames, blobs and event lines (positions and fields) equal the JAX
    monitor's, and every channel holds the vector's frames and the JAX
    catalog's lines (``protocol.edacs.encode.judge``).  At 1 s (~33
    frames) the JAX monitor's top 96 candidates hold every frame;
  - the top-K pin (ROADMAP queue 3): on a 3 s block of the continuous
    channel (~100 frames) the JAX monitor's 96 candidates drop frames
    the block holds; the port's 128 take every one, and the port with
    96 picks exactly the JAX monitor's frames.

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

from dsdneo_tpu.engine import ccbatch as J  # noqa: E402
from dsdneo_tpu.fec import gf  # noqa: E402
from dsdneo_tpu.protocol.base import DecoderContext as JCtx  # noqa: E402
from dsdneo_tpu.protocol.edacs import afs as jafs  # noqa: E402
from dsdneo_tpu.protocol.edacs import decoder as jdec  # noqa: E402
from dsdneo_tpu.symbols.framesync import SYNC_DEFS as JDEFS  # noqa: E402
from dsdneo_tpu.symbols.framesync import SyncHit as JHit  # noqa: E402
from dsdneo_tpu_torch import params  # noqa: E402
from dsdneo_tpu_torch.engine import ccbatch as P  # noqa: E402
from dsdneo_tpu_torch.protocol.base import DecoderContext as TCtx  # noqa
from dsdneo_tpu_torch.protocol.edacs import afs as tafs  # noqa: E402
from dsdneo_tpu_torch.protocol.edacs import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode  # noqa
from dsdneo_tpu_torch.symbols.framesync import SYNC_DEFS as TDEFS  # noqa
from dsdneo_tpu_torch.symbols.framesync import SyncHit as THit  # noqa: E402

import export_torch_tables as X  # noqa: E402

BLOCK_DIBITS = 9600                 # 1 s at 9600 baud
LEADS = (0, 41, 96, 20)             # read standard, EA, ESK; inverted
MODES = ("standard", "ea", "esk", "standard")


@pytest.fixture(scope="module")
def tables():
    return params.load_burst("edacs", "cpu")


def test_bch_code_equals_the_jax_package():
    assert tdec.BCH_40_28_GEN == gf.bch_generator_poly(6, 4)
    np.testing.assert_array_equal(tdec._bch_basis(), jdec._bch_basis())
    rng = np.random.default_rng(2)
    for m in rng.integers(0, 1 << 28, 64).tolist():
        assert tdec.edacs_bch_encode(m) == jdec.edacs_bch_encode(m)


def _events(ctx):
    return [(e.line, e.protocol, e.pos, e.fields) for e in ctx.events]


@pytest.mark.parametrize("ea", [False, True])
def test_catalogs_equal_the_jax_package(ea):
    """The stream's messages and 400 random pairs, in one context each:
    the returned lines and every event (fields included) equal."""
    rng = np.random.default_rng(7 + ea)
    pairs = list(X._EDACS_MESSAGES) + [
        tuple(int(v) for v in rng.integers(0, 1 << 28, 2))
        for _ in range(400)]
    jc, tc = JCtx(), TCtx()
    jd, td = jdec.EdacsDecoder(), tdec.EdacsDecoder()
    jhit = JHit(5, 1.0, next(d for d in JDEFS if d.name == "+EDACS"))
    thit = THit(5, 1.0, next(d for d in TDEFS if d.name == "+EDACS"))
    for m1, m2 in pairs:
        if ea:
            assert td._extended(m1, m2, tc, thit) == jd._extended(
                m1, m2, jc, jhit)
        else:
            assert td._standard(m1, m2, tc, thit) == jd._standard(
                m1, m2, jc, jhit)
    assert _events(tc) == _events(jc) and len(_events(tc)) > 20
    assert vars(tc.state) == vars(jc.state)


def test_afs_split_equals_the_jax_package():
    for text in ("443", "344", "4:3:4", "38", "0", "5:5:1"):
        a, b = tafs.AfsSplit.parse(text), jafs.AfsSplit.parse(text)
        assert (a.a_bits, a.f_bits, a.s_bits) == (b.a_bits, b.f_bits,
                                                  b.s_bits)
        for g in (0, 0x020, 0x048, 0x155, 0x7FF):
            assert a.format(g) == b.format(g)
            assert a.is_agency_call(g) == b.is_agency_call(g)
            assert a.is_fleet_call(g) == b.is_fleet_call(g)


def test_decode_device_blob_equals_the_jax_function():
    rng = np.random.default_rng(11)
    Cx, Tn = 3, 2000
    dib = rng.integers(0, 4, (Cx, Tn)).astype(np.uint8)
    ch = np.array([0, 0, 1, 1, 2, 2, 2, Cx])
    pos = np.array([10, 900, 300, 1740, 0, 600, 1300, 0])
    for h, (m, inv, flips) in enumerate(((0, 0, 0), (5, 1, 0), (13, 0, 4),
                                         (19, 1, 1), (2, 0, 40))):
        fr = X._edacs_frame(*X._EDACS_MESSAGES[m])[48:]
        bits = (fr >> 1) ^ inv
        bits[rng.choice(240, size=flips, replace=False)] ^= 1
        dib[ch[h], pos[h]:pos[h] + 240] = np.where(bits, 3, 1)
    want = np.asarray(J.edacs_cc_decode_device(
        jnp.asarray(dib), jnp.asarray(ch.astype(np.int32)),
        jnp.asarray(pos.astype(np.int32))))
    got = P.edacs_cc_decode_device(torch.as_tensor(dib),
                                   torch.as_tensor(ch), torch.as_tensor(pos))
    assert got.dtype == torch.uint8 and got.shape == (len(ch), 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:2, 8].all() and list(want[:2, 9]) == [0, 1]


def _block(tv, leads, n_dib, offset=0):
    """One block of ``n_dib`` dibits per channel from ``offset`` into the
    stream, own lead and noise per channel (the exporter's check block);
    the last channel of ``leads`` with the FM negated."""
    tvb = dict(tv, dibits=tv["dibits"][offset:])
    if offset:
        tvb["lead"] = np.concatenate([tv["lead"], tv["dibits"]])[
            :offset + len(tv["lead"])]
    parts = [X.burst_check_block("edacs", tvb, ls, n_dib - 2, invert=inv)
             for ls, inv in ((leads[:-1], False), (leads[-1:], True))]
    return np.concatenate(parts)


def _set_modes(pipe, esk):
    for c, m in enumerate(MODES):
        pipe.ctxs[c].state.edacs_ea = m == "ea"
        pipe.ctxs[c].state.edacs_esk = esk if m == "esk" else 0


def _fields(pipe, c):
    return [(e.line, e.pos, sorted(e.fields.items()))
            for e in pipe.events(c)]


def test_monitor_matches_jax_on_the_stream(tables):
    tv = tables.test_vector()
    esk = int(tv["esk"])
    C = len(LEADS)
    tp = P.BatchedEdacsControlPipeline(C, device="cpu")
    jp = J.BatchedEdacsControlPipeline(C)
    _set_modes(tp, esk)
    _set_modes(jp, esk)
    n_checked = 0
    for blk in range(2):
        x = _block(tv, LEADS, BLOCK_DIBITS, blk * BLOCK_DIBITS)
        tfe = tp.frontend_sync_device(torch.as_tensor(x))
        jfe = jp.frontend_sync_device(jnp.asarray(x))
        np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
        n0 = [len(tp.events(c)) for c in range(C)]
        assert tp.events_from_frontend(tfe) == jp.events_from_frontend(jfe)
        ac, at, blob = tp.last_frames
        jac, jat = jp.pick_frames(*jfe[1:])
        np.testing.assert_array_equal(ac, jac)
        np.testing.assert_array_equal(at, jat)
        jblob = np.asarray(J.edacs_cc_decode_device(
            jfe[0], jnp.asarray(jac), jnp.asarray(jat)))
        np.testing.assert_array_equal(blob, jblob)
        tvb = dict(tv, starts=tv["starts"] - blk * BLOCK_DIBITS)
        for c, lead in enumerate(LEADS):
            assert _fields(tp, c) == _fields(jp, c)
            n_checked += edacs_encode.judge(
                tvb, lead, BLOCK_DIBITS - 2,
                [(int(t), blob[h]) for h, t in enumerate(at) if ac[h] == c],
                [e.line for e in tp.events(c)[n0[c]:]], MODES[c], c == 3)
    assert n_checked >= 2 * C * 30


def test_topk_pin_on_a_3s_block(tables):
    """ROADMAP queue 3: the JAX monitor keeps 96 candidates, fewer than
    the ~100 frames of a continuous 3 s block."""
    tv = tables.test_vector()
    n_dib = 28800
    x = X.burst_check_block("edacs", tv, (0, 53), n_dib - 2)
    jp = J.BatchedEdacsControlPipeline(2)
    jfe = jp.frontend_sync_device(jnp.asarray(x))
    jac, jat = jp.pick_frames(*jfe[1:])
    tp = P.BatchedEdacsControlPipeline(2, device="cpu")
    assert tp.SYNC_TOPK == 128 and J.BatchedEdacsControlPipeline.SYNC_TOPK \
        == 96
    tfe = tp.frontend_sync_device(torch.as_tensor(x))
    tac, tat = tp.pick_frames(*tfe[1:])
    tp.SYNC_TOPK = 96
    t96 = tp.pick_frames(*tp.frontend_sync_device(torch.as_tensor(x))[1:])
    np.testing.assert_array_equal(t96[0], jac)
    np.testing.assert_array_equal(t96[1], jat)
    for c, lead in enumerate((0, 53)):
        fr, need = edacs_encode.expected_frames(tv, lead, n_dib - 2)
        got = set(edacs_encode.match_nominal(
            [int(t) for t in tat[tac == c]], fr).values())
        jgot = set(edacs_encode.match_nominal(
            [int(t) for t in jat[jac == c]], fr).values())
        assert len(need) >= 97
        assert need <= got and None not in got
        assert len(need - jgot) >= 2


def test_entry_point_takes_the_card():
    """``BatchedEdacsControlPipeline`` and ``params.load_burst("edacs")``
    with no device run on the card and raise where there is none."""
    if torch.cuda.is_available():
        assert P.BatchedEdacsControlPipeline(1).taps.is_cuda
        assert params.load_burst("edacs").device.type == "cuda"
    else:
        for make in (lambda: P.BatchedEdacsControlPipeline(1),
                     lambda: params.load_burst("edacs")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
