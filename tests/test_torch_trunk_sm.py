"""The port's trunking state machines (``engine/trunk``: ``TrunkSM``,
``TrunkFollower``, ``TrunkScanner`` with the trunk-scan target CSV) and
the DMR Tier III LCN calculator (``engine/lcn_calc``) against the JAX
package's, on the CPU.

Every case of ``tests/test_trunk_follower.py``, the follower cases of
``tests/test_cli_flags.py`` (``test_follower_tune_policy_gates``,
``test_follower_enc_lockout``) and the state machine's timing knobs,
hunt, preemption, grant-to-voice ledger and candidate cache run as one
scenario per case against both packages with one injected clock.  Each
scenario records a trace: every tune call, the phase after every input,
the decision log (``sm.events`` and the ``--sm-log`` file's text), the
enc skips and the grant, release and preemption counts.  Equal means
the two traces are equal; the JAX tests' own assertions hold on the
port's trace.
"""

import importlib
import os

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

PKGS = ("dsdneo_tpu", "dsdneo_tpu_torch")


class Pkg:
    """One package's modules for a scenario."""

    def __init__(self, name):
        self.name = name
        self.trunk = importlib.import_module(f"{name}.engine.trunk")
        self.base = importlib.import_module(f"{name}.protocol.base")
        self.talkgroup = importlib.import_module(f"{name}.core.talkgroup")
        self.lcn = importlib.import_module(f"{name}.engine.lcn_calc")

    def ev(self, protocol="p25p1", **fields):
        return self.base.DecodeEvent("x", protocol, 0, fields)


class Run:
    """A follower on an injected clock, with its trace."""

    def __init__(self, pkg: Pkg, chan_map=None, iden=False, policy=None,
                 tg_policy=None, log_path="", **sm_kw):
        self.pkg = pkg
        self.clock = [0.0]
        self.trace = []
        self.tunes = []
        sm_kw.setdefault("hangtime_s", 1.0)
        sm_kw.setdefault("vc_grace_s", 0.5)
        self.sm = pkg.trunk.TrunkSM(
            lambda f, kind: self.tunes.append((f, kind)) or True,
            now_fn=lambda: self.clock[0], policy=policy, **sm_kw)
        self.sm.log_path = log_path
        ctx = pkg.base.DecoderContext()
        if iden:
            t = pkg.trunk.IdenTable()
            t.add(1, 851_000_000.0, 12500.0, 0.0, 1)
            ctx.state.iden_table = t
        if tg_policy is not None:
            ctx.state.tg_policy = tg_policy
        cm = None
        if chan_map:
            cm = pkg.trunk.ChannelMap()
            cm.entries.update(chan_map)
        self.fo = pkg.trunk.TrunkFollower(
            self.sm, ctx, chan_map=cm, current_freq=lambda: 852_000_000.0)

    def at(self, t):
        self.clock[0] = t
        return self

    def on(self, protocol="p25p1", **fields):
        self.fo.on_event(self.pkg.ev(protocol, **fields))
        self._note("on", protocol, sorted(fields.items()))
        return self

    def tick(self):
        self.fo.tick()
        self._note("tick")
        return self

    def _note(self, *what):
        self.trace.append((self.clock[0],) + what + (
            self.sm.phase.name, tuple(self.tunes), self.sm.cc_freq,
            self.sm.vc_freq, self.sm.current_tg))

    def result(self):
        text = ""
        if self.sm.log_path and os.path.exists(self.sm.log_path):
            with open(self.sm.log_path) as f:
                text = f.read()
        fo = self.fo
        return {"trace": self.trace, "tunes": self.tunes,
                "events": list(self.sm.events), "log": text,
                "phase": self.sm.phase.name, "grants": fo.grants,
                "releases": fo.releases, "enc_skips": fo.enc_skips,
                "enc_locked": sorted(fo.enc_locked),
                "preemptions": fo.preemptions,
                "candidates": list(self.sm.cc_candidates)}


# -- scenarios: each takes a Pkg (and a directory) and returns a Run ---------
def grant_via_iden_table_tunes(p, d):
    r = Run(p, iden=True).on().on(grant=True, channel=0x100A, tg=100, src=7)
    assert r.sm.phase.name == "TUNED"
    assert r.tunes[-1] == (851_000_000.0 + 10 * 12500.0, "voice")
    assert r.sm.current_tg == 100 and r.fo.grants == 1
    return r


def grant_via_channel_map_lpcn(p, d):
    r = Run(p, chan_map={17: 456_000_000.0})
    r.on("dmr").on("dmr", grant=True, lpcn=17, tg=300, src=1)
    assert r.sm.phase.name == "TUNED"
    assert r.tunes[-1] == (456_000_000.0, "voice")
    return r


def release_returns_to_cc(p, d):
    r = Run(p, iden=True).on().on(grant=True, channel=0x1001, tg=5)
    r.on(release=True)
    assert r.sm.phase.name == "ON_CC"
    assert r.tunes[-1] == (852_000_000.0, "cc") and r.fo.releases == 1
    return r


def hangtime_returns_to_cc(p, d):
    r = Run(p, iden=True).on().on(grant=True, channel=0x1001, tg=5)
    r.at(0.4).on()
    r.at(0.9).tick()
    assert r.sm.phase.name == "TUNED"
    r.at(2.5).tick()
    assert r.sm.phase.name == "ON_CC"
    return r


def policy_blocks_grant(p, d):
    r = Run(p, iden=True, policy=lambda tg: tg != 666).on()
    r.on(grant=True, channel=0x1001, tg=666)
    assert r.sm.phase.name == "ON_CC" and r.fo.grants == 0
    r.on(grant=True, channel=0x1001, tg=5)
    assert r.sm.phase.name == "TUNED"
    return r


def unresolvable_grant_ignored(p, d):
    r = Run(p).on(grant=True, channel=0x1001, tg=5)
    assert r.sm.phase.name == "ON_CC" and not r.tunes
    assert r.sm.cc_freq == 852_000_000.0
    return r


def sm_decision_log(p, d):
    r = Run(p, iden=True, log_path=os.path.join(d, f"{p.name}.log"))
    r.on().on(grant=True, channel=0x1001, tg=5).on(release=True)
    text = r.result()["log"]
    assert "ON_CC" in text and "TUNED TG 5" in text and "CC (release" in text
    return r


def tune_policy_gates(p, d):
    r = Run(p, chan_map={1: 852e6})
    r.fo.tune_group = False
    r.on(grant=True, channel=1, tg=100)
    assert not r.tunes
    r.fo.tune_group = True
    r.on(grant=True, channel=1, tg=100)
    assert len(r.tunes) == 1
    r.fo.tune_private = False
    r.on(grant=True, channel=1, tg=0, private=True)
    r.fo.tune_data = False
    r.on(grant=True, channel=1, tg=7, data=True)
    assert len(r.tunes) == 1
    return r


def enc_lockout(p, d):
    r = Run(p, chan_map={1: 852e6}, hangtime_s=0.0)
    r.fo.enc_lockout = True
    r.on(grant=True, channel=1, tg=500, svc=0x40)
    assert not r.tunes and 500 in r.fo.enc_locked
    r.on(grant=True, channel=1, tg=500, svc=0x00)
    assert not r.tunes and r.fo.enc_skips == 2
    r.on(grant=True, channel=1, tg=501, svc=0x00)
    assert len(r.tunes) == 1
    r.fo.clear_enc_lockouts()
    assert not r.fo.enc_locked
    return r


def cc_lost_hunts_the_candidates(p, d):
    """ON_CC → HUNTING after the CC timeout; the hunt rotates the learned
    candidates and the -C map's frequencies with its dwell, in both
    orders of -^."""
    r = Run(p, iden=True, cc_timeout_s=2.0)
    r.sm.hunt_all = [853e6, 852e6, 854e6]
    r.on()
    for t in (1.0, 2.5, 2.6, 3.0, 3.7, 4.8, 6.0):
        r.at(t).tick()
    r.sm.prefer_candidates = False
    for t in (7.1, 8.2, 9.3):
        r.at(t).tick()
    r.at(9.5).on()
    assert r.sm.phase.name == "ON_CC"
    return r


def timing_knobs(p, d):
    """The grant timeout, the force release, the high-error hold and
    the minimum follow dwell (docs/cli.md:629-646 knobs)."""
    r = Run(p, iden=True, grant_timeout_s=1.0, force_release_extra_s=2.0,
            force_release_margin_s=0.5, err_hold_pct=10.0, err_hold_s=3.0,
            min_follow_dwell_s=1.5)
    r.on().on(grant=True, channel=0x1002, tg=9)
    r.at(1.5).tick()                          # no voice: grant timeout
    r.at(2.0).on(grant=True, channel=0x1003, tg=9)
    r.at(2.2).on(errs_pct=25.0)               # voice, high errors
    r.at(3.0).tick()                          # min dwell holds
    r.at(4.0).tick()                          # error hold (until 5.2)
    r.at(5.0).on(lc=True)
    r.at(7.0).tick()
    r.at(8.0).tick()                          # force release
    return r


def audio_gates(p, d):
    r = Run(p, iden=True, voice_hold_s=0.5, mac_hold_s=1.0,
            ring_hold_s=2.0)
    r.on().on(grant=True, channel=0x1001, tg=5)
    out = []
    for t in (0.2, 0.8, 1.5):
        r.at(t)
        out.append(r.sm.audio_eligible())
    r.sm.on_mac_activity()
    r.at(2.0)
    out.append(r.sm.audio_eligible())
    r.sm.on_audio_out()
    r.at(3.5)
    out.append(r.sm.audio_eligible())
    r.at(4.5)
    out.append(r.sm.audio_eligible())
    r.trace.append(tuple(out))
    assert out == [True, False, False, True, True, False]
    return r


def preemption_and_the_pending_grant(p, d):
    """A preempt-enabled higher-priority TG displaces the active call
    (after the minimum dwell, with the cooldown); a grant the SM cannot
    take waits in the grant-to-voice ledger until the release or its
    timeout."""
    path = os.path.join(d, f"{p.name}_groups.csv")
    with open(path, "w") as f:
        f.write("tg,mode,name,priority,preempt\n"
                "100,A,low,10,off\n200,A,high,90,on\n300,A,mid,50,off\n")
    pol = p.talkgroup.TalkgroupPolicy()
    assert pol.import_group_csv(path) == 3
    r = Run(p, iden=True, tg_policy=pol)
    r.fo.grant_voice_to_s = 2.0
    r.on().on(grant=True, channel=0x1001, tg=100)
    r.at(0.5).on(grant=True, channel=0x1002, tg=200)   # before min dwell
    r.at(1.0).on(grant=True, channel=0x1002, tg=200)   # preempts
    r.at(1.2).on(grant=True, channel=0x1003, tg=300)   # parked
    r.at(1.5).on(release=True)                         # takes the parked
    r.at(1.6).on(grant=True, channel=0x1001, tg=100)   # parked
    r.at(4.0).tick()                                   # ledger expired
    r.at(4.1).on(release=True)
    assert r.fo.preemptions == 1
    return r


def cc_cache_round_trip(p, d):
    """The CC candidate cache: saved on each new CC, loaded by the next
    state machine."""
    path = os.path.join(d, f"{p.name}_cc.json")
    r = Run(p, cc_cache_path=path)
    r.on()
    r2 = Run(p, cc_cache_path=path)
    r.trace.append(tuple(r2.sm.cc_candidates))
    assert r2.sm.cc_candidates == [852_000_000.0]
    return r


SCENARIOS = [grant_via_iden_table_tunes, grant_via_channel_map_lpcn,
             release_returns_to_cc, hangtime_returns_to_cc,
             policy_blocks_grant, unresolvable_grant_ignored,
             sm_decision_log, tune_policy_gates, enc_lockout,
             cc_lost_hunts_the_candidates, timing_knobs, audio_gates,
             preemption_and_the_pending_grant, cc_cache_round_trip]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_follower_against_jax(scenario, tmp_path):
    got = {name: scenario(Pkg(name), str(tmp_path)).result()
           for name in PKGS}
    jax_r, port_r = got["dsdneo_tpu"], got["dsdneo_tpu_torch"]
    assert port_r == jax_r
    assert port_r["trace"]


def test_kwargs_from_config():
    from dsdneo_tpu.runtime import config as jcfg
    from dsdneo_tpu_torch.runtime import config as pcfg
    for mode in ("p25p1", "dmr"):
        j = jcfg.RuntimeConfig(dmr_grant_timeout_s=2.5, cache_dir="/c",
                               p25_voice_hold_s=0.3)
        pc = pcfg.RuntimeConfig(dmr_grant_timeout_s=2.5, cache_dir="/c",
                                p25_voice_hold_s=0.3)
        a = Pkg("dsdneo_tpu").trunk.TrunkSM.kwargs_from_config(j, mode)
        b = Pkg("dsdneo_tpu_torch").trunk.TrunkSM.kwargs_from_config(pc,
                                                                     mode)
        assert b == a
        assert b["cc_cache_path"] == "/c/cc_candidates.json"


SCAN_CSV = """id,type,frequency_hz,chan_csv,dwell_ms,activity_hold_ms,modulation
site-a,p25,851012500,,2000,500,c4fm
site-b,dmr,452100000,chans.csv,,0,
bad,p25,notanumber,,,,
,p25,460000000,,,,
site-c,nxdn,0,,,,
site-d,nxdn,153250000,,abc,,auto
"""


def test_trunk_scanner_against_jax(tmp_path):
    """``import_trunk_scan_targets`` and ``load_scan_targets`` on one
    CSV, then the scanner's dwell and activity hold on one clock."""
    path = tmp_path / "targets.csv"
    path.write_text(SCAN_CSV)
    out = {}
    for name in PKGS:
        t = Pkg(name).trunk
        rows = [tuple(vars(x).items())
                for x in t.import_trunk_scan_targets(str(path))]
        clock = [0.0]
        tunes = []
        sc = t.TrunkScanner(lambda f, m: tunes.append((f, m)) or True,
                            dwell_s=1.0, hold_s=0.5,
                            now_fn=lambda: clock[0])
        n = t.load_scan_targets(sc, str(path))
        picks = []
        for step in range(14):
            clock[0] = 0.3 * step
            if step in (5, 6):
                sc.on_activity()
            tg = sc.tick()
            picks.append(None if tg is None else tg.label)
        for i in range(40):
            sc.add_target(t.ScanTarget(freq_hz=1e6 + i, mode="p25p1"))
        out[name] = (rows, n, picks, tunes, len(sc.targets))
    assert out["dsdneo_tpu_torch"] == out["dsdneo_tpu"]
    rows, n, picks, tunes, n_targets = out["dsdneo_tpu_torch"]
    assert n == 3 and n_targets == 32
    assert [r[0][1] for r in rows] == ["site-a", "site-b", "site-d"]


LCN_CSV = "freq\n851.0125\n851.0375 MHz\n851062500\n\n# note\n851.1125\n"


@pytest.mark.parametrize("kw", [
    {}, {"step_hz": 12500}, {"cc_freq_hz": 851_037_500, "cc_lcn": 7},
    {"start_lcn": 3}], ids=["inferred", "step", "cc-anchor", "start"])
def test_calc_dmr_t3_lcn_against_jax(tmp_path, capsys, kw):
    path = tmp_path / "freqs.csv"
    path.write_text(LCN_CSV)
    out = {}
    for name in PKGS:
        rc = Pkg(name).lcn.calc_dmr_t3_lcn(str(path), **kw)
        cap = capsys.readouterr()
        out[name] = (rc, cap.out, cap.err)
    assert out["dsdneo_tpu_torch"] == out["dsdneo_tpu"]
    assert out["dsdneo_tpu"][0] == 0 and out["dsdneo_tpu"][1]


def test_channel_map_heuristic_fill_against_jax():
    for anchors in ({1: 451.0e6, 4: 451.0375e6, 9: 451.1e6},
                    {1: 451.0e6, 3: 451.013e6}):
        got = []
        for name in PKGS:
            m = Pkg(name).trunk.ChannelMap()
            m.entries.update(anchors)
            got.append((m.heuristic_fill(), sorted(m.entries.items())))
        assert got[0] == got[1]


def test_iden_table_against_jax():
    rng = np.random.default_rng(7)
    tabs = [Pkg(n).trunk.IdenTable() for n in PKGS]
    for t in tabs:
        t.add(1, 851e6, 12500.0, 0.0, 1)
        t.add(2, 769e6, 6250.0, 0.0, 2)
    for ch in rng.integers(0, 1 << 16, 200).tolist():
        assert tabs[1].channel_to_freq(ch) == tabs[0].channel_to_freq(ch)
        assert tabs[1].channel_to_slot(ch) == tabs[0].channel_to_slot(ch)
