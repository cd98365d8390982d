"""HTTP graphical frontend over app_control (reference Qt/QML frontend
equivalent).

The reference ships a Qt Quick/QML frontend whose view-models poll
app_control snapshots and enqueue commands (src/ui/qt/,
docs/code_map.md:240-252).  The TPU rebuild has no Android/Qt surface;
the idiomatic graphical frontend here is a browser dashboard speaking
the same two primitives — poll ``MetricsHub.snapshot()``, enqueue into
``CommandQueue``:

  GET  /            dashboard: stat tiles, spectrum + eye canvases,
                    FEC health, call history, fleet channel grid,
                    event feed, tune/squelch/PPM/mute controls
  GET  /snapshot    FrontendMetrics as JSON (generation, freq, SNR,
                    ring fill/drops, decode health, eye/spectrum)
  GET  /events?n=K  last K decode event lines
  GET  /calls       call-history rows (grant/voice/release segmentation
                    via ui.panes.history_from_events, stream seconds)
  GET  /grid        fleet channel-grid cells (``grid_provider``)
  POST /command     {"cmd": "tune", "payload": 851000000.0} → queue

Runs on a daemon thread; bind is loopback-only by default (the
reference's UDP control server makes the same choice, udp_control.cpp).

The port's own copy of ``dsdneo_tpu/app_control/http.py`` (host
Python, the standard library's HTTP server), unchanged in its pages and
replies; ``stop()`` also joins the serve loop and the request threads,
and is safe on a frontend that was never started.
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from dsdneo_tpu_torch.app_control.commands import AppCommand, CommandQueue
from dsdneo_tpu_torch.app_control.snapshot import MetricsHub

# Dark-mode engineering console.  Colors are the validated reference
# data-viz palette's dark column (surface #1a1a19, ink #fff/#c3c2b7,
# categorical slots 1-3 in fixed order for the channel states, status
# good/critical for FEC counters); every colored grid cell also carries
# its state letter so identity is never color-alone.
_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>dsd-neo-tpu</title><style>
:root{color-scheme:dark;
 --surface:#1a1a19;--panel:#222221;--ink:#ffffff;--ink2:#c3c2b7;
 --grid:rgba(255,255,255,.08);--s1:#3987e5;--s2:#d95926;--s3:#199e70;
 --good:#0ca30c;--crit:#d03b3b}
body{font-family:ui-monospace,Menlo,Consolas,monospace;font-size:13px;
 background:var(--surface);color:var(--ink);margin:16px;max-width:1100px}
h1{font-size:15px;margin:0 0 10px;color:var(--ink)}
h2{font-size:12px;margin:14px 0 6px;color:var(--ink2);
 text-transform:uppercase;letter-spacing:.08em;font-weight:600}
.tiles{display:flex;flex-wrap:wrap;gap:8px}
.tile{background:var(--panel);border-radius:6px;padding:8px 12px;
 min-width:96px}
.tile .k{color:var(--ink2);font-size:10px;text-transform:uppercase;
 letter-spacing:.06em}
.tile .v{font-size:17px;margin-top:2px}
.charts{display:flex;gap:12px;flex-wrap:wrap}
.chart{background:var(--panel);border-radius:6px;padding:8px;
 position:relative}
.chart .cap{color:var(--ink2);font-size:11px;margin-bottom:4px}
.chart .read{position:absolute;top:8px;right:10px;color:var(--ink2);
 font-size:11px}
canvas{display:block}
table{border-collapse:collapse;width:100%}
th{color:var(--ink2);text-align:left;font-weight:600;font-size:11px;
 padding:2px 10px 2px 0;border-bottom:1px solid var(--grid)}
td{padding:2px 10px 2px 0;border-bottom:1px solid var(--grid)}
#ev{white-space:pre-wrap;color:var(--ink2);background:var(--panel);
 border-radius:6px;padding:8px;max-height:220px;overflow-y:auto}
#gridbox{display:flex;flex-wrap:wrap;gap:4px}
.cell{border-radius:4px;padding:3px 6px;background:var(--panel);
 color:var(--ink2)}
.cell.voice{outline:2px solid var(--s1)}
.cell.cc{outline:2px solid var(--s2)}
.cell.mute{outline:2px solid var(--s3)}
.cmd{display:flex;gap:8px;flex-wrap:wrap;align-items:center}
input{background:var(--panel);color:var(--ink);border:1px solid
 var(--grid);border-radius:4px;padding:4px 6px;width:90px;
 font:inherit}
button{background:var(--panel);color:var(--ink);border:1px solid
 var(--s1);border-radius:4px;padding:4px 10px;font:inherit;
 cursor:pointer}
.ok{color:var(--good)}.err{color:var(--crit)}
a{color:var(--s1)}
</style></head><body>
<h1>dsd-neo-tpu live <span id="gen" style="color:var(--ink2)"></span></h1>
<div class="tiles" id="tiles"></div>
<h2>Signal</h2>
<div class="charts">
 <div class="chart"><div class="cap">spectrum (dB)</div>
  <div class="read" id="specread"></div>
  <canvas id="spec" width="520" height="150"></canvas></div>
 <div class="chart"><div class="cap">eye &mdash; soft symbols</div>
  <div class="read" id="eyeread"></div>
  <canvas id="eye" width="320" height="150"></canvas></div>
</div>
<h2>FEC health</h2><div class="tiles" id="fec"></div>
<h2>Call history</h2>
<table id="calls"><thead><tr><th>T (s)</th><th>PROTO</th><th>KIND</th>
<th>TG</th><th>SRC</th><th>S</th><th>DUR</th></tr></thead>
<tbody></tbody></table>
<div id="gridsec" style="display:none"><h2>Channel grid</h2>
<div id="gridbox"></div></div>
<h2>Events</h2><div id="ev"></div>
<h2>Control</h2>
<div class="cmd">
 <label>MHz <input id="freq" placeholder="851.0125"></label>
 <button onclick="tune()">Tune</button>
 <label>SQL dB <input id="sql" placeholder="-60"></label>
 <button onclick="cmd('set_squelch',parseFloat(sql.value))">Set</button>
 <label>PPM <input id="ppm" placeholder="0"></label>
 <button onclick="cmd('set_ppm',parseInt(ppm.value))">Set</button>
 <button onclick="cmd('toggle_mute',null)">Mute</button>
 <span style="color:var(--ink2)">raw: <a href="/snapshot">/snapshot</a>
 <a href="/events">/events</a> <a href="/calls">/calls</a></span>
</div>
<script>
const $=id=>document.getElementById(id);
function tile(k,v){return '<div class="tile"><div class="k">'+k+
 '</div><div class="v">'+v+'</div></div>'}
async function cmd(c,p){try{await fetch('/command',{method:'POST',
 body:JSON.stringify({cmd:c,payload:p})})}catch(e){}}
function tune(){const m=parseFloat($('freq').value);
 if(m>0)cmd('tune',m*1e6)}
let spec=[],eye=[];
function drawSpec(){const c=$('spec'),g=c.getContext('2d');
 g.clearRect(0,0,c.width,c.height);if(spec.length<2)return;
 const lo=Math.min(...spec)-3,hi=Math.max(...spec)+3;
 const X=i=>i/(spec.length-1)*(c.width-8)+4;
 const Y=v=>(1-(v-lo)/(hi-lo))*(c.height-8)+4;
 g.strokeStyle='rgba(255,255,255,.08)';g.lineWidth=1;g.beginPath();
 for(let d=Math.ceil(lo/10)*10;d<hi;d+=10){g.moveTo(4,Y(d));
  g.lineTo(c.width-4,Y(d))}g.stroke();
 g.strokeStyle='#3987e5';g.lineWidth=2;g.beginPath();
 spec.forEach((v,i)=>i?g.lineTo(X(i),Y(v)):g.moveTo(X(0),Y(v)));
 g.stroke();c.lo=lo;c.hi=hi}
function drawEye(){const c=$('eye'),g=c.getContext('2d');
 g.clearRect(0,0,c.width,c.height);if(eye.length<8)return;
 const cols=64,Y=v=>(1-(v+4)/8)*(c.height-8)+4;
 g.strokeStyle='rgba(255,255,255,.15)';g.setLineDash([3,4]);
 [-3,-1,1,3].forEach(l=>{g.beginPath();g.moveTo(4,Y(l));
  g.lineTo(c.width-4,Y(l));g.stroke()});g.setLineDash([]);
 g.fillStyle='rgba(57,135,229,.55)';
 eye.forEach((v,i)=>{const x=(i%cols)/cols*(c.width-8)+4;
  g.beginPath();g.arc(x,Y(v),1.6,0,7);g.fill()})}
$('spec').onmousemove=e=>{const c=$('spec');if(spec.length<2)return;
 const i=Math.round((e.offsetX-4)/(c.width-8)*(spec.length-1));
 if(i>=0&&i<spec.length)$('specread').textContent=
  'bin '+i+': '+spec[i].toFixed(1)+' dB'};
$('eye').onmousemove=e=>{const c=$('eye');
 const v=(1-(e.offsetY-4)/(c.height-8))*8-4;
 $('eyeread').textContent=v.toFixed(2)};
async function tick(){try{
 const s=await (await fetch('/snapshot')).json();
 $('gen').textContent='#'+s.generation+(s.retune_muted?' [MUTED]':'');
 $('tiles').innerHTML=
  tile('freq MHz',(s.freq_hz/1e6).toFixed(4))+
  tile('SNR dB',(s.snr_db??0).toFixed(1))+
  tile('CFO Hz',(s.cfo_hz??0).toFixed(0))+
  tile('level rms',(s.input_level_rms??0).toFixed(3))+
  tile('blocks',s.blocks)+tile('retunes',s.retunes)+
  tile('ring',s.ring_fill+'/'+s.ring_drops)+
  tile('sym rate',s.symbol_rate_hz);
 const h=s.health;
 $('fec').innerHTML=
  tile('P25p1','<span class="ok">'+h.p25p1_fec_ok+' ok</span> '+
   '<span class="err">'+h.p25p1_fec_err+' err</span>')+
  tile('DMR','<span class="ok">'+h.dmr_fec_ok+' ok</span> '+
   '<span class="err">'+h.dmr_fec_err+' err</span>')+
  tile('CRC','<span class="ok">'+h.generic_crc_ok+' ok</span> '+
   '<span class="err">'+h.generic_crc_err+' err</span>');
 spec=s.spectrum_db||[];eye=s.eye_symbols||[];drawSpec();drawEye();
 const e=await (await fetch('/events?n=30')).json();
 $('ev').textContent=e.events.join('\\n');
}catch(err){} setTimeout(tick,1000)}
async function slow(){try{
 const c=await (await fetch('/calls')).json();
 $('calls').tBodies[0].innerHTML=c.calls.map(r=>
  '<tr><td>'+r.t_s.toFixed(1)+'</td><td>'+r.protocol+'</td><td>'+
  r.kind+'</td><td>'+r.tg+'</td><td>'+r.src+'</td><td>'+r.slot+
  '</td><td>'+r.dur_s.toFixed(1)+'</td></tr>').join('');
 const g=await (await fetch('/grid')).json();
 if(g.channels.length){$('gridsec').style.display='';
  const gl={voice:'V',cc:'C',idle:'.',mute:'m'};
  $('gridbox').innerHTML=g.channels.map(ch=>
   '<span class="cell '+ch.state+'">'+ch.id+':'+(gl[ch.state]||'?')+
   (ch.tg?' '+ch.tg:'')+'</span>').join('')}
}catch(err){} setTimeout(slow,2000)}
tick();slow();
</script></body></html>"""


class HttpFrontend:
    """Serve snapshots/events/calls/grid and accept commands."""

    def __init__(self, hub: MetricsHub, commands: CommandQueue,
                 events=None, host: str = "127.0.0.1", port: int = 0,
                 grid_provider=None):
        self.hub = hub
        self.commands = commands
        self._events = events if events is not None else []
        self._devents = []    # (DecodeEvent, fs_sym) pairs (calls)
        self.grid_provider = grid_provider
        # default symbol clock for /calls stream-time conversion;
        # engines set it (or pass per-push) so mixed-rate fleets and
        # non-4800-baud modes get correct call times
        self.fs_sym = 4800.0
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 5.0           # a silent client cannot hold stop()

            def log_message(self, *a):        # quiet server
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._reply(200, _PAGE.encode(), "text/html")
                elif u.path == "/snapshot":
                    self._reply(200, outer.snapshot_json().encode())
                elif u.path == "/events":
                    q = parse_qs(u.query)
                    try:
                        n = max(int(q.get("n", ["50"])[0]), 0)
                    except ValueError:
                        self._reply(400, b'{"error": "bad n"}')
                        return
                    with outer._lock:
                        ev = list(outer._events)[-n:] if n else []
                    self._reply(200, json.dumps({"events": ev}).encode())
                elif u.path == "/calls":
                    self._reply(200, outer.calls_json().encode())
                elif u.path == "/grid":
                    gp = outer.grid_provider
                    chans = gp() if gp is not None else []
                    self._reply(200, json.dumps(
                        {"channels": chans}).encode())
                else:
                    self._reply(404, b'{"error": "not found"}')

            def do_POST(self):
                if urlparse(self.path).path != "/command":
                    self._reply(404, b'{"error": "not found"}')
                    return
                n = int(self.headers.get("Content-Length", "0") or 0)
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    cmd = AppCommand(req["cmd"])
                except (ValueError, KeyError, TypeError):
                    # TypeError: body parsed but isn't a dict
                    # ('"tune"', '[1]', 'null')
                    self._reply(400, b'{"error": "bad command"}')
                    return
                ok = outer.commands.put(cmd, req.get("payload"))
                self._reply(200 if ok else 503,
                            json.dumps({"queued": ok}).encode())

        self._srv = ThreadingHTTPServer((host, port), Handler)
        # request threads are joined by stop() (server_close), so none
        # outlives the frontend
        self._srv.daemon_threads = False
        self._srv.block_on_close = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def snapshot_json(self) -> str:
        s = self.hub.snapshot()
        d = asdict(s)
        for k, v in list(d.items()):
            if isinstance(v, np.ndarray):
                d[k] = np.asarray(v, dtype=np.float64).round(2).tolist()
        return json.dumps(d)

    def calls_json(self) -> str:
        """Call-history rows derived from the structured event ring
        (grant/voice/release segmentation, stream-time seconds).  Each
        event's position converts to seconds with the symbol clock it
        was pushed under (mixed-rate fleets carry several)."""
        from types import SimpleNamespace

        from dsdneo_tpu_torch.ui.panes import history_from_events
        with self._lock:
            pairs = list(self._devents)
        evs = [SimpleNamespace(line=e.line, protocol=e.protocol,
                               fields=e.fields, pos=e.pos / fs)
               for e, fs in pairs]
        h = history_from_events(evs, fs_sym=1.0, t0=0.0)
        rows = []
        for s in sorted(h.rings):
            for e in h.rings[s][-24:]:
                row = {
                    "t_s": round(e.when, 2), "protocol": e.protocol,
                    "kind": e.kind.name, "slot": e.slot, "tg": e.tg,
                    "src": e.src,
                    "dur_s": round((e.ended if e.ended is not None
                                    else e.when) - e.when, 2)}
                if e.alias:
                    row["alias"] = e.alias
                if e.gps:
                    row["gps"] = e.gps
                rows.append(row)
        rows.sort(key=lambda r: r["t_s"])
        return json.dumps({"calls": rows[-24:]})

    def push_event(self, line: str, keep: int = 500) -> None:
        """Engine side: append a decode event line to the ring."""
        with self._lock:
            self._events.append(line)
            if len(self._events) > keep:
                del self._events[:len(self._events) - keep]

    def push_decode_event(self, e, keep: int = 500,
                          fs_sym: float | None = None) -> None:
        """Engine side: append a structured DecodeEvent — feeds both
        the line feed and the /calls view.  ``fs_sym`` is the symbol
        clock of ``e.pos`` (defaults to ``self.fs_sym``)."""
        with self._lock:
            self._devents.append((e, float(fs_sym or self.fs_sym)))
            if len(self._devents) > keep:
                del self._devents[:len(self._devents) - keep]
        self.push_event(e.line, keep=keep)

    def start(self) -> "HttpFrontend":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving: end the serve loop (when started), join its
        thread and every request thread, close the socket."""
        if self._thread.is_alive():
            self._srv.shutdown()
            self._thread.join()
        self._srv.server_close()
