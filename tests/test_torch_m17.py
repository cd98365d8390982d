"""The M17 stream pipeline of the PyTorch port against the JAX package's
(``engine/m17batch.py``), on the CPU.

  - ``m17_stream_decode_device`` on random dibits and on the encoded
    frames of the exported stream, pad hits included: the 26-byte blobs
    equal byte for byte;
  - K5 on M17's inputs: ``conv_k5_decode_plain`` against the JAX
    ``conv_k5_decode_batch`` on depunctured stream frames (0/1 symbols,
    0/1 weights, so every branch cost is exact and the two agree bit for
    bit, tolerance 0) and with flipped symbols;
  - the pipeline on the stream of ``data/event_tables.npz`` at C = 3, two
    1.5 s blocks with the contexts kept: the picked hits and blobs equal,
    the accepted frames, every channel's event lines, positions and
    fields equal (the LSF assembly with its callsigns among them),
    ``channel_state`` equal, and the frames hold the vector's
    (``protocol.m17.encode.judge``); where libcodec2 is
    present, the monitored channels' PCM equal to the JAX pipeline's
    (both call the same host library on the same bytes).

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

from dsdneo_tpu.engine import m17batch as J  # noqa: E402
from dsdneo_tpu.fec import device as jdev  # noqa: E402
from dsdneo_tpu.protocol.m17 import decoder as jdec  # noqa: E402
from dsdneo_tpu_torch import params  # noqa: E402
from dsdneo_tpu_torch.engine import m17batch as P  # noqa: E402
from dsdneo_tpu_torch.fec import device as tdev  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr.encode import vector_block  # noqa: E402
from dsdneo_tpu_torch.protocol.m17 import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode  # noqa
from dsdneo_tpu_torch.protocol.m17.encode import fm_iq  # noqa: E402
from dsdneo_tpu_torch.vocoder import codec2  # noqa: E402

import export_torch_tables as X  # noqa: E402

BLOCK_DIBITS = 7200                 # 1.5 s at 4800 baud
LEADS = (0, 53, 96)


@pytest.fixture(scope="module")
def tables():
    return params.load_event("m17", "cpu")


def _stream_hits(tv, rng, n_random=20):
    """A [1, T] dibit row of the stream (dead air as dibit 0) and hit
    positions: every stream frame in it, then random positions."""
    d = np.where(tv["dibits"] == X.EV_DEAD, 0, tv["dibits"])[:6000]
    true = tv["fr_starts"][tv["fr_starts"] + 192 < len(d)]
    pos = np.concatenate([true, rng.integers(0, len(d), n_random)])
    return d[None].astype(np.uint8), pos.astype(np.int64), len(true)


def test_stream_decode_blobs_equal(tables):
    rng = np.random.default_rng(17)
    tv = tables.test_vector()
    d1, pos1, n_true = _stream_hits(tv, rng)
    rnd = rng.integers(0, 4, (2, 3000)).astype(np.uint8)
    for dib, ch, pos in (
            (d1, np.zeros(len(pos1), np.int64), pos1),
            (rnd, np.array([0, 1, 1, 2, 2], np.int64),      # pad channel 2
             np.array([0, 17, 2990, 0, 5], np.int64))):
        want = np.asarray(J.m17_stream_decode_device(
            jnp.asarray(dib), jnp.asarray(ch, np.int32),
            jnp.asarray(pos, np.int32)))
        got = P.m17_stream_decode_device(
            torch.as_tensor(dib), torch.as_tensor(ch), torch.as_tensor(pos),
            tables).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # the stream's frames decode to their FN and payload, LICH clean
    got = P.m17_stream_decode_device(
        torch.as_tensor(d1), torch.zeros(n_true, dtype=torch.int64),
        torch.as_tensor(pos1[:n_true]), tables).numpy()
    np.testing.assert_array_equal((got[:, 0].astype(int) << 8) | got[:, 1],
                                  tv["fr_fn"][:n_true])
    np.testing.assert_array_equal(got[:, 2:18], tv["fr_payload"][:n_true])
    assert not got[:, 24].any()


def _depunctured(tv, n, flips, rng):
    """K5's [n, 296] symbols and weights of the stream's first ``n``
    frames, as ``m17_stream_decode_device`` builds them, with ``flips``
    symbols flipped per frame."""
    scram, inter, keep = P._m17_tables()
    d = tv["dibits"]
    sym = np.zeros((n, 296), np.float32)
    for i, s in enumerate(tv["fr_starts"][:n]):
        dd = d[s + 8:s + 192]
        bits = np.stack([(dd >> 1) & 1, dd & 1], -1).reshape(368)
        deframe = (bits ^ scram)[inter]
        sym[i, keep] = deframe[96:]
        f = keep[rng.choice(272, size=flips, replace=False)]
        sym[i, f] = 1.0 - sym[i, f]
    wt = np.zeros((n, 296), np.float32)
    wt[:, keep] = 1.0
    return sym, wt


@pytest.mark.parametrize("flips", [0, 3])
def test_k5_plain_matches_jax_on_m17_frames(tables, flips):
    """Satellite pin: M17 feeds K5 hard 0/1 symbols with 0/1 weights, so
    the plain version (each product rounded) and the JAX function (XLA
    fuses one product into an FMA) compute the same exact integers."""
    tv = tables.test_vector()
    sym, wt = _depunctured(tv, 24, flips, np.random.default_rng(flips))
    got = tdev.conv_k5_decode_plain(torch.as_tensor(sym),
                                    torch.as_tensor(wt)).numpy()
    want = np.asarray(jax.jit(jdev.conv_k5_decode_batch)(
        jnp.asarray(sym), jnp.asarray(wt)))
    np.testing.assert_array_equal(got, want)
    fn = (got[:, :16] * (1 << np.arange(15, -1, -1))).sum(axis=1)
    np.testing.assert_array_equal(fn, tv["fr_fn"][:24])


def test_host_copies_equal_the_jax_package():
    for name in ("_SCRAMBLE", "_INTERLEAVE", "_P2"):
        np.testing.assert_array_equal(getattr(tdec, name),
                                      getattr(jdec, name))
    assert tdec.DT_NAMES == jdec.DT_NAMES and tdec.ENC_NAMES == jdec.ENC_NAMES
    rng = np.random.default_rng(2)
    for _ in range(5):
        b = rng.integers(0, 2, 240).astype(np.uint8)
        assert np.array_equal(tdec._pack_bytes(b), jdec._pack_bytes(b))
        assert tdec.m17_crc16(tdec._pack_bytes(b)) == \
            jdec.m17_crc16(jdec._pack_bytes(b))
    for v in (0, 0xFFFFFFFFFFFF, 1234567, 40 ** 8 + 5):
        assert tdec.decode_callsign(v) == jdec.decode_callsign(v)
    from dsdneo_tpu.vocoder import codec2 as jc2
    assert codec2.available() == jc2.available()


def _blocks(tv, leads, seed):
    out = []
    for b in range(2):
        tvb = dict(tv, dibits=tv["dibits"][b * BLOCK_DIBITS:])
        if b:
            tvb["lead"] = np.concatenate([tv["lead"], tv["dibits"]])[
                :b * BLOCK_DIBITS + len(tv["lead"])]
        out.append(vector_block(tvb, leads, seed + 10 * b
                                + np.arange(len(leads)), BLOCK_DIBITS * 10,
                                modulate=fm_iq, lead_dibits=tvb["lead"]))
    return out


def _events(pipe, c):
    return [(e.line, e.pos, sorted(e.fields.items())) for e in pipe.events(c)]


def test_pipeline_matches_jax_on_the_stream(tables):
    tv = tables.test_vector()
    C = len(LEADS)
    tp = P.BatchedM17VoicePipeline(C, monitor={0, 2}, device="cpu",
                                   tables=tables)
    jp = J.BatchedM17VoicePipeline(C, monitor={0, 2})
    n_checked = n_lsf = 0
    seen = [set() for _ in range(C)]
    for blk, iq in enumerate(_blocks(tv, LEADS, 40)):
        ga, gt, gb = tp.decode_block_records(torch.as_tensor(iq))
        wa, wt, wb = jp.decode_block_records(jnp.asarray(iq))
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gb, wb)
        assert tp.decode_block_events(iq) == jp.decode_block_events(
            jnp.asarray(iq))
        ac, at, blob = tp.last_frames
        tvb = dict(tv, fr_starts=tv["fr_starts"] - blk * BLOCK_DIBITS)
        for c in range(C):
            assert _events(tp, c) == _events(jp, c)
            assert tp.channel_state(c) == jp.channel_state(c)
            lines = [e.line for e in tp.events(c)]
            n_lsf += sum("SRC:" in ln for ln in lines)
            now = m17_encode.judge(
                tvb, LEADS[c], BLOCK_DIBITS - 2,
                [(int(t), blob[h]) for h, t in enumerate(at) if ac[h] == c],
                lines, P.GOLAY_ERR_MAX, seen[c])
            n_checked += len(now)
            seen[c] |= now
            tp.ctxs[c].events.clear()
            jp.ctxs[c].events.clear()
    assert n_checked >= 100 and n_lsf >= 6
    for c in range(C):
        a, b = tp.pcm(c), jp.pcm(c)
        assert a.dtype == np.float32 and a.shape == b.shape
        if codec2.available() and c in (0, 2):
            assert a.size == 2 * 160 * len(seen[c]) and np.isfinite(a).all()
        else:
            assert a.size == 0


# each pipeline in a process of its own: libcodec2 draws the phases of
# its unvoiced harmonics from one generator per process, so two decoders
# in one process do not see the same draws
_PCM_RUN = """
import sys
import numpy as np
blocks = np.load(sys.argv[1])
out = {}
if sys.argv[3] == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dsdneo_tpu.engine.m17batch import BatchedM17VoicePipeline
    pipe = BatchedM17VoicePipeline(2, monitor={0, 1})
    for k in sorted(blocks.files):
        pipe.decode_block_events(jnp.asarray(blocks[k]))
else:
    from dsdneo_tpu_torch.engine.m17batch import BatchedM17VoicePipeline
    from dsdneo_tpu_torch import params
    pipe = BatchedM17VoicePipeline(2, monitor={0, 1}, device="cpu",
                                   tables=params.load_event("m17", "cpu"))
    for k in sorted(blocks.files):
        pipe.decode_block_events(blocks[k])
np.savez(sys.argv[2], *[pipe.pcm(c) for c in range(2)])
"""


def test_monitored_pcm_equals_jax(tables, tmp_path):
    """Where libcodec2 is present: the two monitored channels' PCM over
    two blocks equals the JAX pipeline's sample for sample, each
    pipeline run in a fresh process."""
    if not codec2.available():
        pytest.skip("libcodec2 is not installed")
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    blocks = _blocks(tables.test_vector(), LEADS[:2], 50)
    np.savez(tmp_path / "blocks.npz", *blocks)
    pcm = {}
    for side in ("jax", "torch"):
        out = tmp_path / f"{side}.npz"
        r = subprocess.run(
            [sys.executable, "-c", _PCM_RUN, str(tmp_path / "blocks.npz"),
             str(out), side], cwd=root, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=root))
        assert r.returncode == 0, r.stderr
        with np.load(out) as z:
            pcm[side] = [z[k] for k in sorted(z.files)]
    for a, b in zip(pcm["torch"], pcm["jax"]):
        assert a.size > 0
        np.testing.assert_array_equal(a, b)
