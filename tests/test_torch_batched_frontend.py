"""The ``cofetch`` contract of the port's batched pipelines (the JAX
package's ``tests/test_batched_frontend.py:7``, for every pipeline the
trunked fleet drives): ``frontend_finish(fe, cofetch=extra)`` copies
the caller's tensors to the host with the candidates and returns (the
plain tuple, them as numpy), a tuple for a tuple, equal to separate
copies; ``fetch_pcm`` takes the host copy of a wire as it takes the
wire; the P25 monitor's ``events_from_frontend(fe6, cofetch=(a, b))``
returns ``(n_parsed, (a, b) as numpy)``.  On the CPU, and on the card
(``cuda`` marker) with the same checks.
"""

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import to_host
from dsdneo_tpu_torch.engine.ccbatch import BatchedP25ControlPipeline
from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
from dsdneo_tpu_torch.engine.dpmrbatch import BatchedDpmrVoicePipeline
from dsdneo_tpu_torch.engine.nxdnbatch import BatchedNxdnVoicePipeline
from dsdneo_tpu_torch.engine.p2batch import BatchedP2VoicePipeline
from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
from dsdneo_tpu_torch.engine.ysfbatch import BatchedYsfVoicePipeline
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode

PIPES = {"p25p1": BatchedP25VoicePipeline, "dmr": BatchedDmrVoicePipeline,
         "nxdn48": BatchedNxdnVoicePipeline, "p25p2": BatchedP2VoicePipeline,
         "dpmr": BatchedDpmrVoicePipeline, "ysf": BatchedYsfVoicePipeline}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(where):
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return where


def _block():
    """Two channels of the P25 vector (0.6 s), float planes."""
    tv = params.load("cpu").test_vector()
    return p25_encode.vector_block(tv, (30, 77), (1, 2), 28800)


def _equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        elif not isinstance(x, torch.Tensor):
            assert x == y


@pytest.mark.parametrize("where", DEVICES)
@pytest.mark.parametrize("mode", sorted(PIPES))
def test_frontend_finish_cofetch_contract(mode, where):
    dev = _device(where)
    pipe = PIPES[mode](2, device=dev)
    iq = _block()
    plain = pipe.frontend_finish(pipe.frontend_dispatch(iq))
    extra = torch.arange(24.0, device=dev).reshape(4, 6)
    got, co = pipe.frontend_finish(pipe.frontend_dispatch(iq),
                                   cofetch=extra)
    assert len(got) == len(plain)
    _equal(plain[1:], got[1:])          # [0] is the device dibits
    assert isinstance(co, np.ndarray)
    np.testing.assert_array_equal(co, extra.cpu().numpy())
    got2, co2 = pipe.frontend_finish(pipe.frontend_dispatch(iq),
                                     cofetch=(extra, extra[:1] + 1))
    _equal(plain[1:], got2[1:])
    assert isinstance(co2, tuple) and len(co2) == 2
    np.testing.assert_array_equal(co2[1], np.arange(1.0, 7.0)[None])


@pytest.mark.parametrize("where", DEVICES)
def test_fetch_pcm_takes_a_host_copy(where):
    dev = _device(where)
    pipe = BatchedP25VoicePipeline(2, pcm_fmt="adpcm", device=dev)
    h = pipe.decode_block_async(_block())
    assert h is not None
    np.testing.assert_array_equal(pipe.fetch_pcm(to_host(h)),
                                  pipe.fetch_pcm(h))
    assert pipe.fetch_pcm(None).shape == (2, 0)
    assert to_host(None) is None
    assert isinstance(to_host([h, h]), tuple)


@pytest.mark.parametrize("where", DEVICES)
def test_p25_monitor_events_cofetch_tuple(where):
    dev = _device(where)
    cc = params.load_cc("p25", dev)
    tv = cc.test_vector()
    from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
    iq = dmr_encode.vector_block(
        tv, (5, 60), (1, 2), 22000, sps=10,
        modulate=lambda d, sps: p25_encode.c4fm_clean(d, sps),
        lead_dibits=tv["lead"])
    a = torch.arange(6, device=dev)
    b = torch.ones(3, device=dev)
    runs = []
    for cof in (None, a, (a, b)):
        pipe = BatchedP25ControlPipeline(2, device=dev, tables=cc)
        out = pipe.events_from_frontend(
            pipe.frontend_finish(pipe.frontend_dispatch(iq)), cofetch=cof)
        runs.append((pipe, out))
    n0 = runs[0][1]
    assert n0 > 0
    assert runs[1][1][0] == n0 and isinstance(runs[1][1][1], np.ndarray)
    n2, co = runs[2][1]
    assert n2 == n0 and isinstance(co, tuple)
    np.testing.assert_array_equal(co[0], np.arange(6))
    np.testing.assert_array_equal(co[1], np.ones(3, np.float32))
    for c in range(2):
        assert [e.line for e in runs[2][0].ctxs[c].events] == \
            [e.line for e in runs[0][0].ctxs[c].events]
