"""The serial decode path's test streams: modulators and judges.

``tools/export_torch_tables.py`` builds two 60 s streams with the JAX
package's own encoders and stores them in ``data/serial_tables.npz``:

  - ``p25_*``: a P25 Phase 1 voice call at 4800 symbols/s (HDU,
    LDU1/LDU2 superframes with the Group Voice Channel User LC and the
    encryption sync, part of them ADP-keyed, a TDULC);
  - ``pv_*``: an EDACS control channel at 9600 symbols/s with ProVoice
    voice superframes between runs of its frames.

Here are their modulators (the P25 call as C4FM or as CQPSK with a
carrier offset, the EDACS/ProVoice stream as 2-level FSK, each with
white noise at 30 dB, 48 kHz) and the judges that hold a decode
context to them: :func:`judge_p25` (every LDU accepted with the
vector's voice bits, every LC, encryption sync and keyed frame right)
and :func:`judge_pv` (every EDACS frame with its message, every ProVoice
superframe with its LID, BF and frames).  A judge raises
``AssertionError`` on the first wrong bit and returns its counts.
"""

from __future__ import annotations

import functools

import numpy as np

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode

FS = 48000.0
P25_SPS = 10              # 4800 symbols/s
PV_SPS = 5                # 9600 symbols/s
SNR_DB = 30.0
CQPSK_CFO_HZ = 150.0      # the CQPSK stream's carrier offset
POS_TOL = 2               # symbols between a frame's sync and its hit
P25_LDU_DIBITS = 863
PV_SUPERFRAME_DIBITS = 32 + 736
EDACS_FRAME_DIBITS = 288


@functools.lru_cache(maxsize=1)
def vector() -> dict[str, np.ndarray]:
    """The arrays of ``data/serial_tables.npz``."""
    with np.load(params.SERIAL_TABLES_NPZ) as z:
        return {k: z[k] for k in z.files}


def p25_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
           cqpsk: bool = False, invert: bool = False,
           seed: int = 0) -> np.ndarray:
    """The first ``n_sym`` symbols of the P25 call (all of it by
    default) as complex64 baseband: C4FM, or π/4-DQPSK with a carrier
    offset of ``CQPSK_CFO_HZ``; ``invert`` conjugates it (an inverted
    channel)."""
    dib = tv["p25_dibits"][:n_sym]
    if cqpsk:
        x = p25_encode.cqpsk_iq(dib, P25_SPS, FS, cfo_hz=CQPSK_CFO_HZ,
                                snr_db=SNR_DB, seed=seed)
    else:
        x = p25_encode.c4fm_iq(dib, P25_SPS, FS, snr_db=SNR_DB, seed=seed)
    return np.conj(x) if invert else x


def pv_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
          invert: bool = False, seed: int = 0) -> np.ndarray:
    """The first ``n_sym`` symbols of the EDACS/ProVoice stream as
    complex64 2-level FSK baseband with white noise."""
    x = edacs_encode.fm_iq(tv["pv_dibits"][:n_sym], PV_SPS)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    x = x + noise * 10 ** (-SNR_DB / 20)
    return (np.conj(x) if invert else x).astype(np.complex64)


class ImbeSink:
    """An ``mbe_sink`` that keeps every voice frame's parameter bits
    (after the decrypt) and its ECC error count, in decode order."""

    def __init__(self):
        self.bits: list[np.ndarray] = []
        self.errs: list[int] = []

    def write(self, bits88, errs) -> None:
        self.bits.append(np.asarray(bits88, np.uint8).copy())
        self.errs.append(int(errs))


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def _near(events, pos: int, pred) -> list:
    return [e for e in events if abs(e.pos - pos) <= POS_TOL and pred(e)]


def _one(events, pos: int, what: str, pred):
    got = _near(events, pos, pred)
    _require(len(got) == 1, f"{what} at symbol {pos}: {len(got)} events")
    return got[0]


def judge_p25(tv: dict[str, np.ndarray], ctx, sink: ImbeSink,
              n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the P25 call's first ``n_sym`` symbols to the
    vector: the HDU; every LDU whose frame the span holds accepted with
    its nine voice frames' bits and, through ``sink``, their clear
    parameter bits (the keyed ones decrypted); the LC of every LDU1 and
    of the TDULC; the encryption sync of every LDU2."""
    n_sym = len(tv["p25_dibits"]) if n_sym is None else n_sym
    nac, tg, src, _key, kid, _seed = (int(v) for v in tv["p25_ids"])
    ev = [e for e in ctx.events if e.protocol == "p25p1"]
    hdu = _one(ev, int(tv["p25_hdu_pos"]), "HDU",
               lambda e: e.line.startswith(" HDU"))
    _require((hdu.fields["algid"], hdu.fields["tgid"]) == (0x80, tg),
             hdu.line)
    imbe = np.unpackbits(tv["p25_imbe"], axis=-1)[..., :144]
    clear = np.unpackbits(tv["p25_clear88"], axis=-1)[..., :88]
    n = int(np.sum(tv["p25_ldu_pos"] + P25_LDU_DIBITS <= n_sym))
    _require(len(sink.bits) >= 9 * n, (len(sink.bits), n))
    keyed = 0
    for i in range(n):
        p, duid = int(tv["p25_ldu_pos"][i]), int(tv["p25_ldu_duid"][i])
        name = "LDU1" if duid == 0x5 else "LDU2"
        head = _one(ev, p, name + " header",
                    lambda e: e.fields.get("duid") == duid)
        _require(head.fields["nac"] == nac, head.line)
        voice = _one(ev, p, name + " voice", lambda e: "imbe" in e.fields)
        np.testing.assert_array_equal(voice.fields["imbe"], imbe[i],
                                      err_msg=f"{name} {i} voice bits")
        np.testing.assert_array_equal(
            np.stack(sink.bits[9 * i:9 * i + 9]), clear[i],
            err_msg=f"{name} {i} clear parameter bits")
        keyed += bool(tv["p25_keyed"][i])
        if duid == 0x5:
            lc = _one(ev, p, "LDU1 LC", lambda e: "src" in e.fields)
            _require((lc.fields["tg"], lc.fields["src"]) == (tg, src),
                     lc.line)
        else:
            es = _one(ev, p, "LDU2 ESS", lambda e: "kid" in e.fields)
            want = tuple(int(v) for v in tv["p25_ess"][i // 2])
            _require((es.fields["algid"], es.fields["kid"]) == want,
                     es.line)
    tp = int(tv["p25_tdulc_pos"])
    if tp + 200 <= n_sym:
        lc = _one(ev, tp, "TDULC LC", lambda e: "src" in e.fields)
        _require((lc.fields["tg"], lc.fields["src"]) == (tg, src), lc.line)
    return {"ldus": n, "keyed_ldus": keyed, "voice_frames": 9 * n}


def judge_pv(tv: dict[str, np.ndarray], ctx,
             n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the EDACS/ProVoice stream's first ``n_sym``
    symbols to the vector: every EDACS frame the span holds with its
    message word, every ProVoice superframe with its LID, BF and four
    7×24 IMBE-7100 frames."""
    n_sym = len(tv["pv_dibits"]) if n_sym is None else n_sym
    ed = [e for e in ctx.events if e.protocol == "edacs"]
    pv = [e for e in ctx.events if e.protocol == "provoice"]
    n_e = 0
    for p, w in zip(tv["pv_edacs_pos"], tv["pv_edacs_word"]):
        if p + EDACS_FRAME_DIBITS > n_sym:
            break
        e = _one(ed, int(p), "EDACS frame", lambda e: "word" in e.fields)
        _require(e.fields["word"] == int(w), e.line)
        n_e += 1
    frames = np.unpackbits(tv["pv_frames"], axis=-1)[..., :24]
    n_p = 0
    for i, p in enumerate(tv["pv_pos"]):
        if p + PV_SUPERFRAME_DIBITS > n_sym:
            break
        e = _one(pv, int(p), "ProVoice superframe",
                 lambda e: "lid" in e.fields)
        _require((e.fields["lid"], e.fields["bf"]) == (
            int(tv["pv_lid"][i]), int(tv["pv_bf"][i])), e.line)
        np.testing.assert_array_equal(e.fields["imbe7100_frames"], frames[i],
                                      err_msg=f"ProVoice {i} frames")
        n_p += 1
    return {"edacs_frames": n_e, "provoice_superframes": n_p}


def _field_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a == b


def events_equal(a, b) -> str | None:
    """None when two event lists agree in every line, protocol, position
    and field (arrays bit for bit), else where they first differ."""
    if len(a) != len(b):
        return f"{len(a)} events vs {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if (x.line, x.protocol, x.pos) != (y.line, y.protocol, y.pos):
            return f"event {i}: {x.line!r}@{x.pos} vs {y.line!r}@{y.pos}"
        if sorted(x.fields) != sorted(y.fields) or not all(
                _field_equal(x.fields[k], y.fields[k]) for k in x.fields):
            return f"event {i} ({x.line!r}): fields differ"
    return None


def pcm(ctx) -> np.ndarray:
    """The decode's slot-0 PCM, concatenated (float32)."""
    return (np.concatenate(ctx.audio[0]) if ctx.audio.get(0)
            else np.zeros(0, np.float32))
