"""The port's frontends against the JAX package's, on the CPU:
``ui/panes.py`` (every pane), ``ui/menu.py``, the views of
``ui/terminal.py`` and its headless exits, and ``app_control/http.py``.

The panes and views are host Python in both packages.  Each is given the
same inputs: the events and decoder state of the port's CPU decode of
2 s of the P25 call of ``data/serial_tables.npz`` and of 1 s of the
bench's P25 control channel (``engine/fleetvec``: its grants), channel
dicts from those contexts, seeded symbol, I/Q and spectrum buffers, and
the JAX test file's hand-made states; the rows must be equal string for
string.  ``call_history_rows`` takes ``now`` (its one wall-clock input)
from the test.

The HTTP frontends of both packages serve hubs given the same publishes
and the same decode events, on ports the OS picks (port 0): ``/``,
``/snapshot``, ``/events``, ``/calls`` (stream time, apart from the
wall-clock ``dur_s`` of a call that a later grant ends, named) and
``/grid`` must be equal byte for byte, and a ``POST /command`` must
queue the same command.  ``stop()`` joins every thread it started.
The terminal frontends also draw on a pseudo-terminal in a child
process, and say when curses finds no terminal.
"""

import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.app_control import commands as JC  # noqa: E402
from dsdneo_tpu.app_control import http as JH  # noqa: E402
from dsdneo_tpu.app_control import snapshot as JS  # noqa: E402
from dsdneo_tpu.ui import menu as JM  # noqa: E402
from dsdneo_tpu.ui import panes as JP  # noqa: E402
from dsdneo_tpu.ui import terminal as JT  # noqa: E402
from dsdneo_tpu_torch.app_control import commands as PC  # noqa: E402
from dsdneo_tpu_torch.app_control import http as PH  # noqa: E402
from dsdneo_tpu_torch.app_control import snapshot as PS  # noqa: E402
from dsdneo_tpu_torch.engine import fleetvec as FV  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.ui import menu as PM  # noqa: E402
from dsdneo_tpu_torch.ui import panes as PP  # noqa: E402
from dsdneo_tpu_torch.ui import terminal as PT  # noqa: E402

WIDTHS = (40, 80, 120)


@pytest.fixture(scope="module")
def decoded():
    """The port's CPU decode of the P25 call and of the bench CC."""
    from dsdneo_tpu_torch.engine.decoder import decode_samples
    call = decode_samples(SV.p25_iq(SV.vector(), 2 * 4800), "p25p1",
                          device="cpu")
    tv = FV.vector()
    cc = decode_samples(FV.c4fm48(tv["bench_cc_dibits"][:4800], 1),
                        "p25p1", device="cpu")
    assert any("VOICE" in e.line for e in call.events)
    assert any("grant" in e.fields or "trunk_grant" in e.fields
               for e in cc.events)
    return call, cc


def _same(f_jax, f_port, *args, **kw):
    a, b = f_jax(*args, **kw), f_port(*args, **kw)
    assert b == a
    return b


# -- panes ---------------------------------------------------------------------
@pytest.mark.parametrize("width", WIDTHS)
def test_history_and_call_history_rows(decoded, width):
    for ctx in decoded:
        for kw in ({}, {"fs_sym": 4800.0, "t0": 0.0},
                   {"fs_sym": 9600.0, "t0": 1000.0}):
            kw.setdefault("t0", 5000.0)     # no wall clock either side
            hj = JP.history_from_events(ctx.events, **kw)
            hp = PP.history_from_events(ctx.events, **kw)
            for s in (None, 0, 1):
                rows = _same(lambda *a, **k: JP.call_history_rows(hj, *a, **k),
                             lambda *a, **k: PP.call_history_rows(hp, *a, **k),
                             width, slot=s, now=kw["t0"] + 9.0)
                assert rows[0].lstrip().startswith("TIME")
    hp = PP.history_from_events(decoded[1].events, t0=0.0)
    assert len(PP.call_history_rows(hp, 100, now=9.0)) >= 2


@pytest.mark.parametrize("width", WIDTHS)
def test_channel_grid_rows(decoded, width):
    ctxs = list(decoded)
    freqs = [851.0125e6, 851.0375e6]
    chj = JP.channels_from_contexts(ctxs, freqs=freqs)
    chp = PP.channels_from_contexts(ctxs, freqs=freqs)
    assert chp == chj and [c["state"] for c in chp] == ["voice", "cc"]
    _same(JP.channel_grid_rows, PP.channel_grid_rows, chp, width)
    many = [{"id": i, "freq_hz": 851e6 + i * 12500,
             "state": ("voice" if i % 7 == 3 else "cc" if i == 0
                       else "mute" if i == 5 else "idle"),
             "tg": 4000 + i if i % 7 == 3 else 0} for i in range(40)]
    _same(JP.channel_grid_rows, PP.channel_grid_rows, many, width)
    _same(JP.channel_grid_rows, PP.channel_grid_rows, many, width,
          cell_w=19)


def _states():
    from dsdneo_tpu_torch.core.affiliation import AffiliationTable
    from dsdneo_tpu_torch.crypto.keyring import KeyRing
    from dsdneo_tpu_torch.engine.trunk import IdenTable
    it = IdenTable()
    it.add(2, 851_000_000.0, 12_500.0, tdma_slots=2)
    it.add(5, 762_006_250.0, 6_250.0, tdma_slots=1)
    aff = AffiliationTable()
    aff.register(1001)
    aff.affiliate(1001, 123)
    aff.patch_update(900, is_patch=True, active=True)
    aff.patch_add_wgid(900, 123)
    kr = KeyRing()
    kr.forced = 0x1234
    return [
        SimpleNamespace(p2_wacn=0xBEE00, p2_sysid=0x14C, nac=0x140,
                        iden_table=it, affiliations=aff, p2_rfssid=5,
                        p2_siteid=9, last_tg=4501, last_src=1234567,
                        payload_algid=0xAA, payload_kid=7,
                        payload_mi=0x1122334455667788, dmr_color_code=1,
                        talker_alias="UNIT 7", last_gps="47.6 -122.3",
                        keyring=kr),
        SimpleNamespace(dmr_color_code=1, dmr_branding="Tier III",
                        dmr_site_parms="TIII Small:2-9;0ABC; ",
                        dmr_rest_channel=7, nxdn_ran=3, last_alias="OPS",
                        m17_sig_status="ECDSA OK", m17_gps="47.6 -122.3",
                        dstar_text="HELLO", dstar_gps="DPRS x",
                        p2_wacn=0, p2_sysid=0, nac=0),
    ]


MODES = ("p25p1", "p25p2", "x2", "dmr", "nxdn48", "edacs", "m17", "dstar",
         "ysf", "dpmr", "")


@pytest.mark.parametrize("width", WIDTHS)
def test_status_detail_and_trunk_rows(decoded, width):
    class _Ev:
        def __init__(self, line, **fields):
            self.line = line
            self.fields = fields

    made = [_Ev("Adjacent Site RFSS 1", neighbors=[0x1018, 0x2020]),
            _Ev("v", slot=0, tg=101, src=42), _Ev("v", slot=1, tg=9, src=3),
            _Ev("grant", afs="03-051", lcn=4), _Ev("C_BCAST ALOHA"),
            _Ev("lsf", dst="ALL", src="N0CALL"), _Ev("Site CCH"),
            _Ev("RPT1 UR"), _Ev("DCH Dest CSD")]
    states = _states() + [ctx.state for ctx in decoded]
    for st in states:
        _same(JP.protocol_status_rows, PP.protocol_status_rows, st,
              "p25p1", width)
        _same(JP.trunk_status_rows, PP.trunk_status_rows, st, width)
        for mode in MODES:
            for evs in (None, made, decoded[0].events, decoded[1].events):
                _same(JP.protocol_detail_rows, PP.protocol_detail_rows,
                      st, evs, mode, width)
            _same(JP.protocol_detail_rows, PP.protocol_detail_rows, st,
                  made, mode, width, height=3)


@pytest.mark.parametrize("width", WIDTHS)
def test_live_status_rows(width):
    for kw in ({}, {"freq_hz": 851.0125e6, "snr_db": 17.2,
                    "cfo_hz": -120.0, "blocks": 99, "retunes": 3,
                    "ring_fill": 12, "ring_drops": 1,
                    "retune_muted": True}):
        hj, hp = JS.MetricsHub(), PS.MetricsHub()
        for h in (hj, hp):
            h.publish(**kw)
            h.bump_health(p25p1_fec_ok=50, p25p1_fec_err=2,
                          generic_crc_ok=4)
        assert PP.live_status_rows(hp.snapshot(), width) == \
            JP.live_status_rows(hj.snapshot(), width)


# -- terminal views ---------------------------------------------------------
def _buffers(seed):
    rng = np.random.default_rng(seed)
    soft = (rng.integers(0, 4, 3000) * 2 - 3
            + 0.3 * rng.standard_normal(3000)).astype(np.float32)
    iq = (rng.standard_normal(20000) + 1j * rng.standard_normal(20000)
          ).astype(np.complex64) * np.exp(1j * 0.05 * np.arange(20000))
    db = (20 * np.log10(np.abs(np.fft.fft(iq[:1024])) + 1e-9)
          ).astype(np.float32)
    return soft, iq, db


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("width", WIDTHS)
def test_view_rows(decoded, seed, width):
    soft, iq, db = _buffers(seed)
    for n in (0, 10, 63, 64, 300, 3000):
        _same(JT._eye_rows, PT._eye_rows, soft[:n], width)
        _same(JT._histogram_rows, PT._histogram_rows, soft[:n], width)
    for n in (0, 63, 64, 255, 256, 20000):
        _same(JT._constellation_rows, PT._constellation_rows, iq[:n], width)
        _same(JT._spectrum_rows, PT._spectrum_rows, iq[:n], width)
    for n in (0, 7, 8, 64, 1024):
        _same(JT._db_bar_rows, PT._db_bar_rows, db[:n], width)
    call = decoded[0]
    hist = PP.history_from_events(call.events, t0=0.0)
    chans = PP.channels_from_contexts(list(decoded))
    for models in (
            (JT.UiModel(), PT.UiModel()),
            tuple(L.UiModel(mode="p25p1", soft=soft, iq=iq, history=hist,
                            channels=chans, state=call.state,
                            events=call.events) for L in (JT, PT))):
        assert PT._VIEWS == JT._VIEWS
        for view in PT._VIEWS + ("other",):
            if view == "calls" and models[0].history is not None:
                continue            # wall-clock "now": covered above
            assert PT._view_rows(models[1], view, width) == \
                JT._view_rows(models[0], view, width)


def test_run_exits_headless():
    """``run`` with a bounded idle count returns (whether or not curses
    finds a terminal), as the CLI's ``--frontend terminal`` does when
    stdin is not a tty."""
    done = threading.Event()

    def ui():
        try:
            PT.run(PT.UiModel(mode="p25p1", lines=["a", "b"]),
                   max_idle_polls=2)
        finally:
            done.set()
    threading.Thread(target=ui, daemon=True).start()
    assert done.wait(timeout=15), "run did not exit headless"


def test_run_live_exits_headless():
    """The JAX test's case on the port's engine (on the CPU, named)."""
    from dsdneo_tpu_torch.engine.live import LiveEngine
    eng = LiveEngine("p25p1", fs=48000.0, block_s=0.1, device="cpu")
    eng.metrics.publish(freq_hz=851e6, snr_db=10.0, blocks=1)
    done = threading.Event()

    def ui():
        try:
            PT.run_live(eng, duration=0.0, events=["line one"],
                        max_idle_polls=3)
        finally:
            done.set()
    threading.Thread(target=ui, daemon=True).start()
    assert done.wait(timeout=15), "run_live did not exit headless"


# the frontends on a pseudo-terminal: each child process below draws on
# the pty's slave, which is its stdin and stdout; the test types keys
# into the master once the first frame is up and reads what was drawn
_PTY_CHILD = {
    "run": """
import json, sys
from dsdneo_tpu_torch.app_control.commands import CommandQueue
from dsdneo_tpu_torch.ui.terminal import UiModel, run
q = CommandQueue()
drawn = run(UiModel(mode="p25p1", lines=["line one", "line two"]),
            max_idle_polls=8, queue=q)
print(json.dumps({"drawn": drawn, "commands": [
    [c.cmd.value, c.payload] for c in q.drain()]}), file=sys.stderr)
""",
    "run_live": """
import json, sys, time
from dsdneo_tpu_torch.engine.live import LiveEngine
from dsdneo_tpu_torch.ui.terminal import run_live
eng = LiveEngine("p25p1", fs=48000.0, block_s=0.1, device="cpu")
eng.metrics.publish(freq_hz=851e6, snr_db=10.0, blocks=1)
n, snap = [0], eng.metrics.snapshot
def counted():
    n[0] += 1
    return snap()
eng.metrics.snapshot = counted
eng.start()
drawn = run_live(eng, duration=0.0, events=["line one"], max_idle_polls=8)
t = time.time()
while eng.retunes == 0 and time.time() - t < 5:
    time.sleep(0.05)           # the engine drains commands between blocks
eng.stop()
print(json.dumps({"drawn": drawn, "snapshots": n[0],
                  "freq_hz": eng.freq_hz, "retunes": eng.retunes}),
      file=sys.stderr)
""",
}
# m opens the menu, Enter enters "Tuning", Enter picks "Set frequency"
_TUNE_KEYS = [b"m", b"\r", b"\r", b"851.0125", b"\r"]


def _on_a_pty(child: str, keys: list[bytes], env: dict | None = None):
    """Run ``child`` with a 30x100 pty as its stdin and stdout, typing
    ``keys`` once it has drawn its header; returns the JSON line it
    printed last on stderr and the bytes it drew."""
    import fcntl
    import json
    import os
    import pty
    import select
    import struct
    import subprocess
    import sys
    import termios
    import time
    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen([sys.executable, "-c", child], stdin=slave,
                         stdout=slave, stderr=subprocess.PIPE, cwd=root,
                         env=env or dict(os.environ, TERM="xterm"))
    os.close(slave)
    out, typed = bytearray(), False
    try:
        deadline = time.time() + 90
        while time.time() < deadline:
            if select.select([master], [], [], 0.1)[0]:
                try:
                    chunk = os.read(master, 65536)
                except OSError:             # EIO: the child closed it
                    chunk = b""
                if not chunk:
                    break
                out += chunk
            elif p.poll() is not None:
                break
            if not typed and b"dsd-neo-tpu" in out:
                for k in keys:
                    os.write(master, k)
                    time.sleep(0.1)
                typed = True
        _, err = p.communicate(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        os.close(master)
    assert p.returncode == 0, err.decode()[-2000:]
    return json.loads(err.decode().strip().splitlines()[-1]), bytes(out)


@pytest.mark.parametrize("frontend", sorted(_PTY_CHILD))
def test_frontends_draw_and_take_keys_on_a_pty(frontend):
    """On a terminal each frontend draws its frames, reads its keys and
    sends the menu's command: ``run`` turns to its next view on ``v``
    and queues the tune; ``run_live`` reads a metrics snapshot for every
    frame (at least its idle polls' worth) and the tune reaches the
    running engine between its blocks."""
    keys = ([b"v"] if frontend == "run" else []) + _TUNE_KEYS
    res, out = _on_a_pty(_PTY_CHILD[frontend], keys)
    assert res["drawn"] is True
    assert b"sent tune 851012500.0" in out
    if frontend == "run":
        assert PT._VIEWS[1].encode() in out       # curses draws the change
        assert res["commands"] == [["tune", 851012500.0]]
    else:
        assert b"dsd-neo-tpu LIVE | p25p1 | 851.0000 MHz" in out
        assert res["snapshots"] >= 8
        assert res["freq_hz"] == 851012500.0 and res["retunes"] == 1


def test_frontends_without_a_terminal_say_they_drew_nothing():
    """With no terminal type curses cannot start: both frontends return
    False (the CLI then says so on stderr) instead of drawing."""
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "TERM"}
    child = """
from dsdneo_tpu_torch.ui.terminal import UiModel, run, run_live
class Engine:
    pass
print(run(UiModel(), max_idle_polls=1), run_live(Engine(), max_idle_polls=1))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", child], cwd=root, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"]


# -- menu -----------------------------------------------------------------
KEYS = {
    "tune": [ord("x"), 10, 10, *map(ord, "851.0125"), 10],
    "mode": [10, 258, 10, 10, 258, 258, 258, 10],
    "squelch-bad": [10, 258, 10, 258, 10, *map(ord, "-6x"), 263, 263,
                    *map(ord, "zz"), 10],
    "mute": [10, 258, 258, 10, 10],
    "hold": [10, 259, 259, 10, 10, *map(ord, "4501"), 10],
    "nav": [10, 258, 261, 260, 27, 259, 27, 27, 10, 259, 13],
}


@pytest.mark.parametrize("seq", sorted(KEYS))
def test_menu_state(seq):
    qj, qp = JC.CommandQueue(), PC.CommandQueue()
    mj, mp = JM.MenuState(queue=qj), PM.MenuState(queue=qp)
    mj.toggle(), mp.toggle()
    for ch in KEYS[seq]:
        assert mp.handle_key(ch) == mj.handle_key(ch)
        for w in (20, 44):
            assert mp.render_rows(w) == mj.render_rows(w)
        assert (mp.open, mp.status) == (mj.open, mj.status)
        if not mj.open:
            mj.toggle(), mp.toggle()
    got = [(c.cmd.value, c.payload) for c in qp.drain()]
    assert got == [(c.cmd.value, c.payload) for c in qj.drain()]
    assert [i.label for i in PM.default_menu()] == \
        [i.label for i in JM.default_menu()]


# -- HTTP -----------------------------------------------------------------
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/command",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _calls_wall(res):
    """``/calls`` with its one wall-clock field named: a call that a
    grant of another talkgroup ends closes at ``time.time()`` (both
    packages' ``EventHistory.begin_call``), so its ``dur_s`` is the wall
    clock less its stream time, and two reads apart differ by the time
    between them.  Such a ``dur_s`` reads ``"wall"`` (within 60 s of
    now)."""
    import json
    import time
    status, ctype, body = res
    rows = json.loads(body)["calls"]
    for r in rows:
        if r["dur_s"] > 1e8:
            assert abs(r["t_s"] + r["dur_s"] - time.time()) < 60
            r["dur_s"] = "wall"
    return status, ctype, json.dumps({"calls": rows})


def test_http_frontends_serve_the_same_bytes(decoded):
    threads0 = set(threading.enumerate())
    soft, iq, db = _buffers(3)
    grid = PP.channels_from_contexts(list(decoded), freqs=[851e6, 852e6])
    fronts = {}
    for name, H, S, Q in (("jax", JH, JS, JC), ("port", PH, PS, PC)):
        hub, q = S.MetricsHub(), Q.CommandQueue()
        f = H.HttpFrontend(hub, q, port=0, grid_provider=lambda: grid)
        f.fs_sym = 4800.0
        f.start()
        hub.publish(freq_hz=851.0125e6, snr_db=17.5, blocks=42,
                    symbol_rate_hz=4800, eye_symbols=soft[:512],
                    spectrum_db=db[::4])
        hub.bump_health(p25p1_fec_ok=3, dmr_fec_err=1)
        for i, e in enumerate(decoded[0].events + decoded[1].events):
            f.push_decode_event(e, fs_sym=(None if i % 3 else 9600.0))
        f.push_event("a plain line")
        fronts[name] = (f, q)
    try:
        for path in ("/", "/snapshot", "/events", "/events?n=3",
                     "/events?n=0", "/events?n=5000", "/calls", "/grid"):
            want = _get(fronts["jax"][0].port, path)
            got = _get(fronts["port"][0].port, path)
            if path == "/calls":
                got, want = _calls_wall(got), _calls_wall(want)
            assert got == want, path
        calls = _get(fronts["port"][0].port, "/calls")[2]
        assert b'"kind": "GROUP_VOICE"' in calls
        for path in ("/events?n=x", "/nope"):
            for name in ("jax", "port"):
                with pytest.raises(urllib.error.HTTPError) as ex:
                    _get(fronts[name][0].port, path)
                fronts[name] += (ex.value.code,)
        assert fronts["port"][2:] == fronts["jax"][2:] == (400, 404)
        for body in (b'{"cmd": "tune", "payload": 852500000.0}',
                     b'{"cmd": "toggle_mute"}', b'{"cmd": "warp-core"}',
                     b'"tune"', b"[1]", b"null", b"{bad"):
            assert _post(fronts["port"][0].port, body) == \
                _post(fronts["jax"][0].port, body)
        qj, qp = fronts["jax"][1].drain(), fronts["port"][1].drain()
        assert [(c.cmd.value, c.payload) for c in qp] == \
            [(c.cmd.value, c.payload) for c in qj] == \
            [("tune", 852500000.0), ("toggle_mute", None)]
    finally:
        for f, *_ in fronts.values():
            f.stop()
    fp = fronts["port"][0]
    assert not fp._thread.is_alive()
    left = [t for t in set(threading.enumerate()) - threads0
            if t.is_alive() and not t.daemon]
    assert left == []


def test_http_stop_without_start_and_event_ring():
    f = PH.HttpFrontend(PS.MetricsHub(), PC.CommandQueue(), port=0)
    for i in range(700):
        f.push_event(f"line {i}", keep=500)
    assert len(f._events) == 500 and f._events[-1] == "line 699"
    t = threading.Thread(target=f.stop, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "stop() of an unstarted frontend hung"
