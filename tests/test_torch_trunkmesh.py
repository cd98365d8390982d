"""``parallel/trunkfleet.ShardedTrunkedFleet`` in the PyTorch port against
the JAX package's, on the CPU: the port on two spawned gloo ranks (one
system each), the JAX fleet on a two-device mesh, on the bands that
``tests/test_trunkmesh.py`` builds (192 kHz, 3 s a system, 1 s blocks):

  - P25 Phase 1, both systems granted, decoded, released; the noise-only
    band; the prefetch path (0.5 s blocks) against the plain path;
  - DMR Tier III through a ``ChannelMap``; EDACS with the analog NBFM
    tone; mixed-phase P25 (both TDMA slots of one row);
  - NXDN48 on ``engine/fleetvec.nxdn_band`` (768 kHz, 2 s; the JAX test's
    NXDN case reads a fixture this repo lacks), the same band on both
    systems.

Held equal to JAX: the stats, each system's log lines, the offsets after
every step, the calls, the rows (parked rows included) and every CC
context's events; the PCM within 2e-3 of its peak.  World size 1 equals
world size 2 bit for bit (PCM, offsets, log) on the P25 case.  Each
spawn runs all its cases in one pair of rank processes.
"""

import dataclasses
import re

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu_torch.engine import fleetvec as FV  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.parallel import dist as pdist  # noqa: E402

FS = 192000.0
CENTER = 851_000_000.0
CC_OFF = -48_000
VC_OFF = 48_000
B = int(FS)
NXDN_CENTER = 451_000_000.0


# -- the rank side (no JAX) ---------------------------------------------------
def drive(mesh, cases: dict) -> dict | None:
    """Each case's fleet on this rank's system(s) over its blocks: the PCM
    and offsets after every step, gathered, and the fleet's view and
    every system's CC events at the end (returned by rank 0)."""
    from dsdneo_tpu_torch.parallel.trunkfleet import ShardedTrunkedFleet
    out = {}
    for name, (kw, blocks, prefetch) in cases.items():
        f = ShardedTrunkedFleet(mesh, **kw)
        offs = []
        if prefetch:
            steps = [f.step(blocks[0], prefetch=blocks[1])]
            steps += [f.step(None, prefetch=b) for b in blocks[2:]]
            steps += [f.step(None)]
        else:
            steps = []
            for b in blocks:
                steps.append(f.step(b))
                offs.append(pdist.gather_rows(mesh, f.offs))
        pcms = [pdist.gather_rows(mesh, p) for p in steps]
        view = f.gather()
        events = pdist.gather_objects(mesh, [c.events
                                             for c in f._cc_host.ctxs])
        out[name] = {"pcm": pcms, "offs": offs, "view": view,
                     "events": [e for part in events for e in part]}
    return out if mesh.rank == 0 else None


# -- the bands ----------------------------------------------------------------
def _cases() -> dict:
    """name → (fleet kwargs without the mesh, blocks, prefetch)."""
    import test_trunkmesh as T
    from dsdneo_tpu_torch.engine.trunk import ChannelMap
    from test_fleettrunk_edacs import LCN
    from test_fleettrunk_nxdn import CHAN

    common = dict(n_systems=2, fs=FS, B=B, cc_offsets_hz=[CC_OFF, CC_OFF],
                  centers_hz=CENTER)
    p25 = np.stack([T._build_system(101, seed=10),
                    T._build_system(202, seed=20)])
    cases = {}
    cases["p25p1"] = (dict(common, n_voice_rows=2, hangtime_s=0.6,
                           grant_grace_s=0.5, max_tsdus=4, max_ldus=4),
                      [p25[:, i * B:(i + 1) * B] for i in range(3)]
                      + [np.zeros_like(p25[:, :B])], False)
    rng = np.random.default_rng(5)
    noise = (rng.normal(size=(2, B, 2)) * 0.3).astype(np.float32)
    cases["noise"] = (dict(common, n_voice_rows=1),
                      [noise, np.zeros((2, B, 2), np.float32)], False)
    half = B // 2
    pre = np.stack([T._build_system(101, seed=50, seconds=1.5,
                                    voice_until=1.5),
                    T._build_system(202, seed=60, seconds=1.5,
                                    voice_until=1.5)])
    pre_kw = dict(common, B=half, n_voice_rows=1, hangtime_s=0.6,
                  grant_grace_s=0.5, max_tsdus=4, max_ldus=2)
    pre_blocks = [pre[:, i * half:(i + 1) * half] for i in range(3)]
    cases["plain"] = (pre_kw, pre_blocks, False)
    cases["prefetch"] = (pre_kw, pre_blocks, True)

    cm = ChannelMap()
    cm.entries[24] = CENTER + VC_OFF
    dmr = np.stack([T._build_dmr_system(101, 24, seed=30),
                    T._build_dmr_system(202, 24, seed=40)])
    cases["dmr"] = (dict(common, n_voice_rows=2, mode="dmr", hangtime_s=0.6,
                         grant_grace_s=0.5, chan_map=cm, max_tsdus=8,
                         max_ldus=8),
                    [dmr[:, i * B:(i + 1) * B] for i in range(3)]
                    + [np.zeros((2, B), np.complex64)], False)

    cm = ChannelMap()
    cm.entries[LCN] = CENTER + VC_OFF
    one = T._build_edacs_system()
    cases["edacs"] = (dict(common, n_voice_rows=2, mode="edacs",
                           hangtime_s=0.6, grant_grace_s=0.5, chan_map=cm,
                           max_tsdus=8),
                      [np.stack([one, one])[:, i * B:(i + 1) * B]
                       for i in range(3)]
                      + [np.zeros((2, B), np.complex64)], False)

    one = T._build_mixed_system()
    cases["p25_mixed"] = (dict(common, n_voice_rows=2, mode="p25_mixed",
                               hangtime_s=0.6, grant_grace_s=0.5,
                               max_tsdus=4, max_ldus=6,
                               p2_params=(T.WACN_M, T.SYSID_M, T.NAC_M)),
                          [np.stack([one, one])[:, i * B:(i + 1) * B]
                           for i in range(3)]
                          + [np.zeros((2, B), np.complex64)], False)

    tv = FV.vector()
    cc_off, vc_off = (int(x) for x in tv["nxdn_offs"])
    band = FV.nxdn_band(tv).numpy()
    nb = int(FV.MODE_FS)
    cm = ChannelMap()
    cm.entries[CHAN] = NXDN_CENTER + vc_off
    cases["nxdn48"] = (dict(n_systems=2, fs=FV.MODE_FS, B=nb,
                            cc_offsets_hz=[cc_off, cc_off],
                            centers_hz=NXDN_CENTER, n_voice_rows=2,
                            mode="nxdn48", hangtime_s=0.6,
                            grant_grace_s=0.5, chan_map=cm, max_tsdus=8,
                            max_ldus=12),
                       [np.stack([band, band])[:, i * nb:(i + 1) * nb]
                        for i in range(2)]
                       + [np.zeros((2, nb), np.complex64)], False)
    return cases


def _jax_fleet(kw, blocks, prefetch):
    """The JAX fleet on a two-device mesh over the same blocks: (fleet,
    PCM per step, offsets per step)."""
    import jax
    from jax.sharding import Mesh
    from dsdneo_tpu.engine.trunk import ChannelMap as JMap
    from dsdneo_tpu.parallel.trunkfleet import ShardedTrunkedFleet
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("sys",))
    kw = dict(kw)
    if kw.get("chan_map") is not None:
        cm = JMap()
        cm.entries.update(kw["chan_map"].entries)
        kw["chan_map"] = cm
    f = ShardedTrunkedFleet(mesh, **kw)
    offs = []
    if prefetch:
        pcm = [f.step(blocks[0], prefetch=blocks[1])]
        pcm += [f.step(None, prefetch=b) for b in blocks[2:]]
        pcm += [f.step(None)]
    else:
        pcm = []
        for b in blocks:
            pcm.append(np.asarray(f.step(b)))
            offs.append(f.offs.copy())
    return f, [np.asarray(p) for p in pcm], offs


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    two = pdist.spawn(drive, 2, cases, device="cpu")[0]
    one = pdist.spawn(drive, 1, {"p25p1": cases["p25p1"]},
                      device="cpu")[0]
    return cases, two, one


def _by_system(log, S):
    """A JAX fleet's log lines grouped per system, in system order."""
    per = [[] for _ in range(S)]
    for ln in log:
        per[int(re.search(r" sys (\d+) ", ln).group(1))].append(ln)
    return [ln for lines in per for ln in lines]


def _calls(calls):
    return [{k: (c.tg, c.src, c.freq_hz, c.system, c.pcm_samples)
             for k, c in d.items()} for d in calls]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    peak = np.abs(a).max(initial=0.0)
    if peak > 0:
        assert np.abs(a - b).max() <= 2e-3 * peak
    else:
        assert not np.abs(b).max(initial=0.0)


def assert_matches_jax(case, port):
    kw, blocks, prefetch = case
    jf, jpcm, joffs = _jax_fleet(kw, blocks, prefetch)
    view = port["view"]
    assert dataclasses.asdict(view.stats) == dataclasses.asdict(jf.stats)
    assert view.log == _by_system(jf.log, jf.S)
    assert view.other_log == [ln for ln in jf.log if " sys " not in ln]
    assert view.offs.tolist() == jf.offs.tolist()
    for a, b in zip(joffs, port["offs"]):
        assert a.tolist() == b.tolist()
    assert view.rows == jf.row_dicts()
    assert _calls(view.calls) == _calls(jf.calls)
    assert _calls(view.calls2) == _calls(jf.calls2)
    for s in range(jf.S):
        assert SV.events_equal(jf._cc_host.ctxs[s].events,
                               port["events"][s]) is None
    assert len(jpcm) == len(port["pcm"])
    for a, b in zip(jpcm, port["pcm"]):
        _close(a, b)
    return jf


def test_p25_grants_retarget_rows_per_system(runs):
    cases, two, _one = runs
    jf = assert_matches_jax(cases["p25p1"], two["p25p1"])
    assert jf.stats.grants == 2 and jf.stats.releases == 2
    pcm1 = two["p25p1"]["pcm"][1]
    assert np.abs(pcm1[0, 0]).max() > 1e-4 and np.abs(pcm1[1, 0]).max() > 1e-4
    assert np.abs(pcm1[0, 1]).max() == 0.0          # parked row masked
    assert two["p25p1"]["view"].offs[0, 1] == CC_OFF


def test_world_one_equals_world_two(runs):
    _cases_, two, one = runs
    a, b = one["p25p1"], two["p25p1"]
    for x, y in zip(a["pcm"] + a["offs"], b["pcm"] + b["offs"]):
        np.testing.assert_array_equal(x, y)
    assert a["view"].log == b["view"].log
    assert a["view"].rows == b["view"].rows
    assert a["view"].stats == b["view"].stats


def test_noise_only_band_stays_quiet(runs):
    cases, two, _one = runs
    jf = assert_matches_jax(cases["noise"], two["noise"])
    assert jf.stats.grants == 0
    assert all(np.abs(p).max() == 0.0 for p in two["noise"]["pcm"])


def test_prefetch_path_equals_plain_path(runs):
    cases, two, _one = runs
    plain, pre = two["plain"], two["prefetch"]
    for a, b in zip(plain["pcm"], pre["pcm"]):
        np.testing.assert_array_equal(a, b)
    assert plain["view"].stats == pre["view"].stats
    assert plain["view"].offs.tolist() == pre["view"].offs.tolist()
    assert plain["view"].stats.grants == 2
    assert_matches_jax(cases["prefetch"], pre)


@pytest.mark.parametrize("mode", ["dmr", "edacs", "p25_mixed", "nxdn48"])
def test_mode_closed_loop_against_jax(runs, mode):
    cases, two, _one = runs
    jf = assert_matches_jax(cases[mode], two[mode])
    view = two[mode]["view"]
    assert jf.stats.grants == (4 if mode == "p25_mixed" else 2)
    assert jf.stats.releases == jf.stats.grants
    e = np.abs(two[mode]["pcm"][1]).mean(axis=2)
    assert (e[:, 0] > 1e-3).all()
    if mode == "p25_mixed":
        assert (e[:, 1] > 1e-3).all() and (e[:, 2:] == 0).all()
    else:
        assert (e[:, 1] == 0).all()
    assert all(r["state"] in ("cc", "idle") for r in view.rows)
