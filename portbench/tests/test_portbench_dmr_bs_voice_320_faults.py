"""``correct`` comes out false on the DMR cell (``dmr_bs_voice_320``)
under each fault its program can have, driven through the rest of a run
on the CPU at the ``"small"`` size (the look for a card skipped), as
``test_portbench_correct.py`` plants its faults in the P25 pipeline.

The faults, planted in ``BatchedDmrVoicePipeline`` underneath the timed
path: a decode that hands its voice carry on unchanged; half of the
channels left out; an answer altered where it is produced (one AMBE+2
frame's ``bits49`` changed after the ECC, one superframe gathered one
dibit off)."""

import pytest

from portbench import harness
from portbench.tests.test_portbench_correct import SEED, small

CELLS = [w["name"] for w in harness.load_spec()["workloads"]
         if w["config"] == "dmr_bs_voice_320"]


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state_unchanged(entry, monkeypatch):
    pipe = entry.pipe
    orig = pipe.decode_from_frontend

    def decode(fe):
        st = pipe._vstate
        h = orig(fe)
        pipe._vstate = st
        return h
    monkeypatch.setattr(pipe, "decode_from_frontend", decode)


def _half_left_out(entry, monkeypatch):
    pipe = entry.pipe
    orig = pipe.frontend_dispatch

    def dispatch(iq):
        x = iq.clone()
        x[x.shape[0] // 2:] = 0
        return orig(x)
    monkeypatch.setattr(pipe, "frontend_dispatch", dispatch)


def _bits49_altered(entry, monkeypatch):
    from dsdneo_tpu_torch.engine import dmrbatch
    orig = dmrbatch.ambe_ecc_batch

    def ecc(bits72, tables):
        bits49, errs = orig(bits72, tables)
        bits49 = bits49.clone()
        bits49[0, 48] ^= 1
        return bits49, errs
    monkeypatch.setattr(dmrbatch, "ambe_ecc_batch", ecc)


def _superframe_off_by_one(entry, monkeypatch):
    pipe = entry.pipe
    orig = pipe.pick_superframes

    def pick(*a, **k):
        ac, at, ai, fch, forder = orig(*a, **k)
        if at.size:
            at = at.copy()
            at[0] += 1
        return ac, at, ai, fch, forder
    monkeypatch.setattr(pipe, "pick_superframes", pick)


def test_the_cell_is_in_the_benchmark():
    assert CELLS == ["dmr.keyed"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _bits49_altered, _superframe_off_by_one],
                         ids=["state_unchanged", "half_left_out",
                              "bits49_altered", "superframe_off_by_one"])
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    cfg, mix = small(cell)
    r = harness.run_cell(cell, SEED, 10.0, False, device="cpu",
                         overrides=cfg, mix_overrides=mix,
                         on_ready=lambda e: fault(e, monkeypatch))
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1
