"""The per-layer metrics that read the program's own spans and counters
(``portbench/spans.py``): a small traced run of each cell on the CPU
gives every one of them, each from the profiled span's blocks; every
per-layer metric of ``BENCHMARK.json`` has its reader; and a program
without the tracer gives none of them and raises nothing."""

import sys

import pytest

from portbench import harness
from portbench.tests.test_portbench_correct import SEED, SMALL

SPEC = harness.load_spec()
PROGRAM = [m for m in SPEC["per_layer"]
           if m["source"] in ("program_span", "program_counter")]


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_program_metrics_are_the_eight():
    assert [m["name"] for m in PROGRAM] == [
        "h2d_wait_ms", "frontend_enqueue_ms", "candidates_wait_ms",
        "pick_ms", "decode_enqueue_ms", "pcm_wait_ms", "pcm_expand_ms",
        "synth_slot_use_pct"]
    for m in SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reads_the_programs_spans(cell):
    cfg, mix = SMALL[cell]
    r = harness.run_cell(cell, SEED + 5, 3.0, True, device="cpu",
                         overrides=cfg, mix_overrides=mix)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for m in PROGRAM:
        assert m["name"] in got, m["name"]
        assert got[m["name"]]["unit"] == m["unit"]
    ms = [got[m["name"]]["value"] for m in PROGRAM if m["unit"] == "ms"]
    assert all(v >= 0 for v in ms) and got["pick_ms"]["value"] > 0
    assert 0 < got["synth_slot_use_pct"]["value"] <= 100
    # the program's spans open no profiler range
    names = {n for n, _v in r["breakdown"]["device_ops"]}
    names |= {n for n, _v in r["breakdown"]["idle_gaps"]}
    assert not any(n.startswith(("p25.", "band.")) for n in names)


def test_without_the_tracer_the_readers_give_nothing(monkeypatch):
    import dsdneo_tpu_torch.runtime as rt
    monkeypatch.delattr(rt, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "dsdneo_tpu_torch.runtime.trace", None)
    for m in PROGRAM:
        assert harness.reader(m["name"])(None) is None
