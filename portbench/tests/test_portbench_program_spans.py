"""The per-layer metrics that read the program's own spans and counters
(``portbench/spans.py``): every such metric of ``BENCHMARK.json`` has its
reader; a small traced run of each cell on the CPU gives every one of
them that applies to the cell, each from the profiled span's blocks; and
a program without the tracer gives none of them and raises nothing."""

import sys

import pytest

from portbench import harness
from portbench.tests.test_portbench_correct import CELLS, SEED, small

SPEC = harness.load_spec()
PROGRAM_SOURCES = ("program_span", "program_counter")
PROGRAM = [m for m in SPEC["per_layer"] if m["source"] in PROGRAM_SOURCES]


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("metric", [m["name"] for m in PROGRAM])
def test_every_program_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_programs_spans(cell):
    from dsdneo_tpu_torch.runtime import trace
    cfg, mix = small(cell)
    r = harness.run_cell(cell, SEED + 5, 3.0, True, device="cpu",
                         overrides=cfg, mix_overrides=mix)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    mine = [m for m in harness.resolve(SPEC, cell).per_layer
            if m["source"] in PROGRAM_SOURCES]
    for m in mine:
        assert m["name"] in got, m["name"]
        assert got[m["name"]]["unit"] == m["unit"]
    ms = [got[m["name"]]["value"] for m in mine if m["unit"] == "ms"]
    assert all(v >= 0 for v in ms)
    if "pick_ms" in got:
        assert got["pick_ms"]["value"] > 0
    if "synth_slot_use_pct" in got:
        assert 0 < got["synth_slot_use_pct"]["value"] <= 100
    # the program's spans open no profiler range
    prefixes = tuple({n.split(".")[0] + "."
                      for n, *_ in trace.last_session().spans})
    assert prefixes or not mine
    names = {n for n, _v in r["breakdown"]["device_ops"]}
    names |= {n for n, _v in r["breakdown"]["idle_gaps"]}
    assert not any(n.startswith(prefixes) for n in names)


def test_without_the_tracer_the_readers_give_nothing(monkeypatch):
    import dsdneo_tpu_torch.runtime as rt
    monkeypatch.delattr(rt, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "dsdneo_tpu_torch.runtime.trace", None)
    for m in PROGRAM:
        assert harness.reader(m["name"])(None) is None
