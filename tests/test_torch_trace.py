"""The port's tracer (``dsdneo_tpu_torch.runtime.trace``) and the spans
and counters of ``BatchedP25VoicePipeline`` and the band's copy, on the
CPU: nothing kept with the profiler off; under ``torch.profiler`` every
span once a block with the block's number, the counters equal to what
the pipeline decoded, the PCM bit for bit the same; the spans on the
profiler's clock; one session a profiled period; no program span among
the profiler's events."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dsdneo_tpu_torch.runtime import trace

C = 4
B = 72000                    # 1.5 s: 8 whole LDUs a channel
LEADS = (30, 77, 5, 140)
SPANS = ("p25.h2d", "p25.frontend_enqueue", "p25.candidates_d2h",
         "p25.pick", "p25.decode_enqueue", "p25.pcm_d2h", "p25.pcm_expand")


@pytest.fixture(scope="module")
def tables():
    from dsdneo_tpu_torch import params
    return params.load("cpu")


@pytest.fixture(scope="module")
def blocks(tables):
    from dsdneo_tpu_torch.protocol.p25 import encode
    tv = tables.test_vector()
    return [torch.from_numpy(encode.vector_block(tv, LEADS, seeds, B))
            for seeds in ((11, 12, 13, 14), (21, 22, 23, 24))]


def _pipe(tables):
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    return BatchedP25VoicePipeline(C, pcm_fmt="f16", device="cpu",
                                   tables=tables)


def _run(pipe, blocks):
    """The benchmark's pipelined order: block N+1 dispatched before block
    N's candidates are fetched, block N−1's PCM fetched last.  Returns
    the PCM and (frame channels, steps) of each block."""
    pcm, decoded = [], []
    fe = pipe.frontend_dispatch(blocks[0])
    prev = None
    for i in range(len(blocks)):
        nxt = (pipe.frontend_dispatch(blocks[i + 1])
               if i + 1 < len(blocks) else None)
        h = pipe.decode_from_frontend(pipe.frontend_finish(fe))
        decoded.append((len(pipe.last_frames[2]), pipe.last_steps))
        if prev is not None:
            pcm.append(pipe.fetch_pcm(prev))
        prev, fe = h, nxt
    pcm.append(pipe.fetch_pcm(prev))
    return pcm, decoded


def test_off_keeps_nothing(tables, blocks):
    assert not trace.on()
    assert trace.span("a", 0) is trace.span("b", 1)
    before = trace.last_session()
    n = (len(before.spans), len(before.counts))
    pipe = _pipe(tables)
    _run(pipe, blocks)
    after = trace.last_session()
    assert after is before and (len(after.spans), len(after.counts)) == n
    assert pipe.blocks == 2


def test_spans_and_counters_once_a_block(tables, blocks):
    pipe = _pipe(tables)
    plain, _ = _run(_pipe(tables), blocks)
    pipe.frontend_finish(pipe.frontend_dispatch(blocks[0]))   # block 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pcm, decoded = _run(pipe, blocks)                    # blocks 1, 2
    s = trace.last_session()
    for name in SPANS:
        got = sorted(b for n, b, t0, t1 in s.spans if n == name)
        assert got == [1, 2], name
    assert all(t1 >= t0 for _n, _b, t0, t1 in s.spans)
    assert {n for n, *_ in s.spans} == set(SPANS)
    by = {}
    for n, b, k in s.counts:
        by.setdefault(n, {})[b] = k
    assert by["p25.blocks"] == {1: 1, 2: 1}
    assert by["p25.frames"] == {1 + i: d[0] for i, d in enumerate(decoded)}
    assert by["p25.synth_slots"] == {1 + i: C * d[1]
                                     for i, d in enumerate(decoded)}
    assert s.total("p25.frames") == 2 * 9 * 8 * C
    for a, b in zip(pcm, plain):
        np.testing.assert_array_equal(a, b)
    # the tracer opens no profiler range
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & set(SPANS)


def test_spans_are_on_the_profilers_clock():
    """A ``record_function`` marker opened inside a span lies within the
    span's start and end, to 1 ms, on the profiler's own stamps."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with trace.span("test.outer", k):
                with record_function(f"test.marker{k}"):
                    torch.ones(64).sum()
    spans = {b: (t0, t1) for n, b, t0, t1 in trace.last_session().spans
             if n == "test.outer"}
    marks = {int(e.name()[-1]): (e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("test.marker")}
    assert sorted(marks) == sorted(spans) == [0, 1, 2]
    for k, (m0, m1) in marks.items():
        t0, t1 = spans[k]
        assert t0 - 1_000_000 <= m0 <= m1 <= t1 + 1_000_000, (k, t0, m0,
                                                              m1, t1)


def test_a_session_a_profiled_period(tables, blocks):
    pipe = _pipe(tables)
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.decode_block(blocks[0])
    first = trace.last_session()
    assert first.total("p25.blocks") == 1
    assert trace.last_session() is first           # readable after the stop
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.decode_block(blocks[1])
    second = trace.last_session()
    assert second is not first
    assert {b for _n, b, *_ in second.spans} == {1}
    assert {b for _n, b, *_ in first.spans} == {0}


def test_the_bands_copy_is_a_span_of_the_next_block(tables):
    """``decode_wideband_voice_batched`` stamps the band's copy with the
    number its pipeline gives the block next."""
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.engine.wideband import \
        decode_wideband_voice_batched
    fs, n_ch = 768000.0, 16
    band = np.random.default_rng(5).standard_normal(
        (48000, 2)).astype(np.float32)
    pipe = BatchedP25VoicePipeline(n_ch, pcm_fmt="f16", device="cpu",
                                   tables=tables)
    pipe.blocks = 7
    with profile(activities=[ProfilerActivity.CPU]):
        decode_wideband_voice_batched(band, fs, n_ch, pcm_fmt="f16",
                                      pipe=pipe, device="cpu")
    s = trace.last_session()
    assert [(n, b) for n, b, *_ in s.spans if n.endswith(".h2d")] == [
        ("band.h2d", 7), ("p25.h2d", 7)]


def test_a_sink_gets_every_span_without_the_profiler():
    got = []

    class Sink:
        def on_span(self, name, block, t0, t1):
            got.append((name, block, t1 >= t0))

    sink = Sink()
    trace.attach(sink)
    try:
        assert trace.on()
        with trace.span("live.decode", 3):
            pass
        trace.count("p25.frames", 9)        # counters are the profiler's
    finally:
        trace.detach(sink)
    assert not trace.on()
    with trace.span("live.decode", 4):
        pass
    assert got == [("live.decode", 3, True)]
