"""``correct`` comes out true on a sound run and false under the control
and under each fault the cells can have, driven through the rest of a
run on the CPU at a small size (the look for a card skipped): each cell
of ``BENCHMARK.json`` at the ``"small"`` overrides of its
configuration's file and of its traffic mix's file.

The faults, planted in the program underneath the timed path (the P25
pipeline, so on the cells whose entry drives it): a decode that hands
its voice carry on unchanged; half of the channels left out;
an answer altered where it is produced (one LDU gathered one dibit off,
one channel's PCM muted).  The cells run on one card,
so no exchange between cards can be left out."""

import json
import os

import numpy as np
import pytest

from portbench import compare, control, harness
from portbench.reference import p25_judge

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 3 * 2 ** 31 + 17
# the entries whose pipeline the planted faults below hook; a
# configuration with another entry brings its own fault test
P25_ENTRIES = ("p25_pipelined", "wideband_batched")


def small(cell: str) -> tuple[dict, dict]:
    """The CPU size of ``cell``: the ``"small"`` overrides of its
    configuration's file and of its traffic mix's file."""
    w = harness.resolve(SPEC, cell)
    return w.cfg["small"], w.mix["small"]


def _entry_of(cell: str) -> str:
    w = {x["name"]: x for x in SPEC["workloads"]}[cell]
    c = {x["name"]: x for x in SPEC["configs"]}[w["config"]]
    with open(os.path.join(harness.ROOT, c["file"])) as fh:
        return json.load(fh)["entry"]


P25_CELLS = [c for c in CELLS if _entry_of(c) in P25_ENTRIES]


@pytest.fixture(autouse=True)
def _few_threads():
    """Two threads a test, so parallel workers leave each run's window
    blocks to complete."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None):
    cfg, mix = small(cell)
    return harness.run_cell(cell, SEED, 10.0, False, device="cpu",
                            overrides=cfg, mix_overrides=mix,
                            on_ready=fault)


def _state_unchanged(entry):
    pipe = entry.pipe
    orig = pipe.decode_from_frontend

    def decode(fe):
        st = pipe.voice_state()
        h = orig(fe)
        pipe.set_voice_state(*st)
        return h
    pipe.decode_from_frontend = decode


def _half_left_out(entry):
    pipe = entry.pipe
    orig = pipe.frontend_dispatch

    def dispatch(iq):
        x = iq.clone()
        x[x.shape[0] // 2:] = 0
        return orig(x)
    pipe.frontend_dispatch = dispatch


def _ldu_off_by_one(entry):
    pipe = entry.pipe
    orig = pipe.pick_ldus

    def pick(*a, **k):
        ac, at, fch, forder = orig(*a, **k)
        if at.size:
            at = at.copy()
            at[0] += 1
        return ac, at, fch, forder
    pipe.pick_ldus = pick


def _pcm_muted(entry):
    pipe = entry.pipe
    orig = pipe.fetch_pcm

    def fetch(h):
        pcm = orig(h).copy()
        pcm[0] = 0.0
        return pcm
    pipe.fetch_pcm = fetch


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert list(r)[-1] == "checks"
    w = harness.resolve(SPEC, cell)
    assert set(r["metrics"]) == {m["name"] for m in w.end_to_end}


@pytest.mark.parametrize("cell", P25_CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _ldu_off_by_one, _pcm_muted],
                         ids=["state_unchanged", "half_left_out",
                              "ldu_off_by_one", "pcm_muted"])
def test_a_fault_makes_the_run_incorrect(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    """The reference in the precision below the configuration's, put in
    the program's place, fails the committed limits; the program on the
    same blocks passes them."""
    cfg, mix = small(cell)
    r = control.readings(cell, SEED + 1, 2, True, device="cpu",
                         overrides=cfg, mix_overrides=mix)
    limits = harness.resolve(SPEC, cell).cfg["limits"]
    assert compare.judge(r["program"], limits)[0], r
    assert not compare.judge(r["control"], limits)[0], r
    if "pcm_rms_rel" in limits:
        assert r["control"]["pcm_rms_rel"] > limits["pcm_rms_rel"]


def test_judge_needs_every_number_and_limit():
    assert compare.judge({"a": 0}, {"a": 0})[0]
    assert not compare.judge({"a": 1}, {"a": 0})[0]
    assert not compare.judge({"a": 0}, {"a": 0, "b": 1})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 1})[0]
    assert p25_judge.carry_rel(None, None) == 0.0
    bits = np.zeros((2, 88), np.uint8)
    m = p25_judge.MARGINAL
    want = (bits, np.zeros(2), np.array([0, 0]), np.array([0, 1]),
            np.array([1.0, 0.5 * m]))
    off = bits.copy()
    off[:, 87] = 1
    # the frame within the margin may differ, the other may not
    assert p25_judge.frames_diff((off[1:], np.zeros(1), [0], [1]),
                                 want) == 1
    assert p25_judge.frames_diff((np.vstack([bits[:1], off[1:]]),
                                  np.zeros(2), [0, 0], [0, 1]), want) == 0
    assert p25_judge.frames_diff((np.vstack([bits[:1], off[1:]]),
                                  np.zeros(2), [0, 0], [0, 1]), want,
                                 0.0) == 1
    assert p25_judge.pcm_sums(np.zeros((2, 3)), np.ones((2, 4)))[0] == 8.0
