"""The live one-tuner path's test drive: the closed loop in lockstep, and
its judge.

One tuner follows the JAX bench's trunked cell (``engine/fleetvec``,
``data/fleet_tables.npz``): a P25 control channel whose TSDUs carry
IDEN_UP and a Group Voice Channel Grant of TG 101 on channel 0x1018
(851.15 MHz), and the granted call, 11 LDUs of IMBE voice.  The source
is a function of the engine's last tune: the control channel (its
dibits repeated, C4FM at 48 kHz with white noise, ``fleetvec.c4fm48``)
while the tuner sits on :data:`CC_HZ`; after a tune to :data:`VC_HZ`,
one block of carrier noise (the block the retune mute window drops),
the call, and noise for the hangtime.  ``TrunkFollower`` and ``TrunkSM``
drive the tuner through ``LiveEngine.tune``: CC → voice → CC after the
hangtime.

No threads run: the test feeds the source's CU8 bytes for the current
tune into the ring, then ``LiveEngine.run(max_blocks=...)`` drains them;
a retune purges what is left, so block boundaries never depend on
timing.  The state machine's clock advances 0.25 s with every decoded
block.  The classes come in as arguments, so the same drive runs the JAX
package's engine (in its tests) and the port's on any device.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.engine import fleetvec

FS = 48000.0
BLOCK_S = 0.25
BLOCK = int(FS * BLOCK_S)
CC_HZ = 850_904_000.0                 # the bench CC: 851 MHz − 96 kHz
VC_HZ = 851_150_000.0                 # the grant's channel 0x1018
TG = fleetvec.BENCH_TG
CC_CHUNK = 8 * BLOCK                  # 2 s of control channel a feed
TAIL_BLOCKS = 12                      # noise after the call: > hangtime
LEVEL = 0.7                           # CU8 scale: the C4FM peak below 1


def cu8(x: np.ndarray) -> bytes:
    """Complex baseband → the rtl_tcp wire: interleaved offset-binary
    bytes, ``round(v · 127.5 + 127.5)`` clipped to 0..255."""
    pl = np.stack([x.real, x.imag], axis=-1).astype(np.float64) * LEVEL
    return np.clip(np.round(pl * 127.5 + 127.5), 0, 255).astype(
        np.uint8).tobytes()


def _noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n))
            * 10 ** (-fleetvec.SNR_DB / 20)).astype(np.complex64)


class Source:
    """The tuner's samples as a function of its last tune."""

    def __init__(self, tv: dict[str, np.ndarray]):
        cc = np.tile(tv["bench_cc_dibits"], 4)
        self.cc = fleetvec.c4fm48(cc, 1)
        self.cc_at = 0
        call = fleetvec.c4fm48(tv["bench_vc_dibits"], 2)
        self.vc = np.concatenate([_noise(BLOCK, 3), call,
                                  _noise(TAIL_BLOCKS * BLOCK, 4)])

    def chunk(self, freq_hz: float) -> np.ndarray:
        if freq_hz == VC_HZ:
            return self.vc
        if self.cc_at + CC_CHUNK > self.cc.shape[0]:
            raise RuntimeError("the control channel ran out: no grant "
                               "was followed")
        x = self.cc[self.cc_at:self.cc_at + CC_CHUNK]
        self.cc_at += CC_CHUNK
        return x


class ClosedLoop:
    """``LiveEngine`` + ``TrunkFollower`` + ``TrunkSM`` on the source,
    built from the classes given (one package's), the engine with
    ``engine_kw`` (the port's takes ``device=``)."""

    def __init__(self, engine_cls, sm_cls, follower_cls, sink,
                 engine_kw: dict | None = None, hangtime_s: float = 1.0):
        self.clock = [0.0]
        self.tunes: list[tuple[float, str]] = []
        # (tunes so far, protocol, symbol position, line); the grant's
        # own event is delivered after the tune it causes
        self.events: list[tuple] = []
        self.eng = eng = engine_cls("p25p1", fs=FS, block_s=BLOCK_S,
                                    retune_mute_s=0.075,
                                    on_event=self._on_event,
                                    **(engine_kw or {}))
        eng.decoder.ctx.mbe_sink = sink
        self.sink = sink

        def tune(f_hz, kind):
            self.tunes.append((float(f_hz), kind))
            eng.tune(f_hz)
            return True

        self.sm = sm_cls(tune, hangtime_s=hangtime_s,
                         now_fn=lambda: self.clock[0])
        fol = follower_cls(self.sm, eng.decoder.ctx,
                           current_freq=lambda: eng.freq_hz)
        tick = fol.tick

        def timed_tick():                 # one decoded block: 0.25 s
            self.clock[0] += BLOCK_S
            tick()

        fol.tick = timed_tick
        eng.trunk = fol
        eng.freq_hz = CC_HZ

    def _on_event(self, e) -> None:
        self.events.append((len(self.tunes), e.protocol, e.pos, e.line))

    def run(self, tv: dict[str, np.ndarray], max_feeds: int = 8) -> None:
        """Feed and drain until the tuner is back on the CC after the
        call (or ``max_feeds`` feeds)."""
        src = Source(tv)
        for _ in range(max_feeds):
            x = src.chunk(self.eng.freq_hz)
            self.eng.feed_cu8(cu8(x))
            self.eng._stop = False
            self.eng.run(max_blocks=x.shape[0] // BLOCK)
            if [k for _, k in self.tunes] == ["voice", "cc"]:
                return


def judge(loop: ClosedLoop, tv: dict[str, np.ndarray]) -> dict:
    """The closed loop's contract: the tunes CC → voice (TG 101 at
    851.15 MHz) → CC, and every LDU of the call with the vector's IMBE
    bits, each frame's ECC clean.  Returns the counts."""
    want = [(VC_HZ, "voice"), (CC_HZ, "cc")]
    if loop.tunes != want:
        raise AssertionError(f"tunes {loop.tunes}, want {want}")
    if not any(n == 1 and "Group Voice Channel Grant" in ln
               for n, _p, _pos, ln in loop.events):
        raise AssertionError("no grant decoded on the control channel")
    bits = np.asarray(loop.sink.bits, np.uint8).reshape(-1, 88)
    ref = tv["bench_vc_bits88"]
    if bits.shape != ref.shape or not np.array_equal(bits, ref):
        bad = (bits.shape[0] if bits.shape != ref.shape
               else int((bits != ref).any(-1).sum()))
        raise AssertionError(f"{bits.shape[0]} IMBE frames of "
                             f"{ref.shape[0]}; {bad} differ")
    if any(loop.sink.errs):
        raise AssertionError(f"ECC errors {sum(loop.sink.errs)}")
    return {"frames": int(bits.shape[0]), "ldus": int(bits.shape[0] // 9),
            "events": len(loop.events), "clock_s": loop.clock[0]}
