"""The reader of ``handoff_wait_pct`` over a tracer session made here:
the share of the results handed over that the host waited for, None
where no result was handed over, and None from a program without the
tracer."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness

READ = harness.reader("handoff_wait_pct")


def _session(**counts):
    from dsdneo_tpu_torch.runtime import trace
    with profile(activities=[ProfilerActivity.CPU]):
        for blk in range(2):
            trace.count("p25.blocks", 1, blk)
            for name, n in counts.items():
                trace.count(f"p25.{name}", n, blk)
    return trace.last_session()


def test_the_share_of_the_handoffs_that_waited():
    s = _session(handoffs=4, handoff_waited=1, blocking_handoffs=0)
    assert s.total("p25.handoffs") == 8
    assert READ(None) == pytest.approx(25.0)
    _session(handoffs=2, handoff_waited=2, blocking_handoffs=3)
    assert READ(None) == pytest.approx(100.0)


def test_no_handoff_gives_nothing():
    _session(blocking_handoffs=3)
    assert READ(None) is None


def test_without_the_tracer_it_gives_nothing(monkeypatch):
    import dsdneo_tpu_torch.runtime as rt
    monkeypatch.delattr(rt, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "dsdneo_tpu_torch.runtime.trace", None)
    assert READ(None) is None


def test_a_cpu_pipeline_reads_every_handoff_as_waited():
    """On the CPU device every result is a blocking copy, which waits for
    all that is queued: the share reads 100."""
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.protocol.p25 import encode
    tables = params.load("cpu")
    pipe = BatchedP25VoicePipeline(2, pcm_fmt="f16", device="cpu",
                                   tables=tables)
    iq = encode.vector_block(tables.test_vector(), (30, 77), (11, 12), 72000)
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.fetch_pcm(pipe.decode_from_frontend(
            pipe.frontend_finish(pipe.frontend_dispatch(iq))))
    assert READ(None) == pytest.approx(100.0)
