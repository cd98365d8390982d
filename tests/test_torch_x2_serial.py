"""The X2-TDMA serial decoder of the PyTorch port against the JAX
package's, on the CPU: ``decode_samples(..., "x2tdma", device="cpu")`` on
``engine.x2batch.synth_x2_voice_stream(n_superframes=3, seed=2)`` (as
``tests/test_x2batch.py`` decodes it) and on ~4 s of the ``x2_*`` stream
of ``data/serial_tables.npz``: every event's line, position, protocol
and fields equal, the AMBE bits handed to ``decode_ambe_2450`` equal,
the port's decode holding the vector (``engine.serialvec.judge_x2``),
and the PCM within 2e-3 of the JAX package's peak.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import x2batch as jx2batch  # noqa: E402
import dsdneo_tpu.vocoder.mbe as jmbe  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
import dsdneo_tpu_torch.vocoder.mbe as tmbe  # noqa: E402

X2_SYM = 4 * 6000                    # 4 s of the X2-TDMA stream
PCM_REL = 2e-3


def _both(x):
    with SV.AmbeSpy(jmbe) as js:
        jc = jdec.decode_samples(x, "x2tdma")
    with SV.AmbeSpy(tmbe) as ts:
        tc = tdec.decode_samples(x, "x2tdma", device="cpu")
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    assert len(js.bits) == len(ts.bits) > 0
    np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))
    assert sorted(jc.audio) == sorted(tc.audio)
    for slot in jc.audio:
        a, b = SV.pcm(jc, slot), SV.pcm(tc, slot)
        assert a.shape == b.shape and np.isfinite(b).all()
        assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    return jc, tc, ts


@pytest.mark.parametrize("stream", ["synth", "vector"])
def test_x2_decode_samples(stream):
    if stream == "synth":
        x, _dib, bits49 = jx2batch.synth_x2_voice_stream(n_superframes=3,
                                                          seed=2)
        jc, tc, ts = _both(x)
        # the walk of slot 0's superframes from its first sync
        np.testing.assert_array_equal(np.stack(ts.bits)[:18], bits49[0, :18])
        assert any("X2-TDMA" in e.line and "VC" in e.line
                   for e in tc.events)
    else:
        tv = SV.vector()
        jc, tc, ts = _both(SV.x2_iq(tv, X2_SYM))
        got = SV.judge_x2(tv, tc, ts, X2_SYM)
        assert got["superframes"] >= 12
