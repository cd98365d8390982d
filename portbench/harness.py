"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
found by name; the harness only sequences a run and aggregates:

- ``portbench/configs/<config>.json``: the deployment, which names its
  input generator ``portbench/inputs/<inputs>.py`` (``make_ring``), its
  entry driver ``portbench/entries/<entry>.py`` (class ``Entry``), its
  reference ``portbench/reference/<reference>.py`` (class ``Reference``,
  which computes the numbers of ``correct``) and their ``limits``;
- ``portbench/traffic/<traffic>.json``: the mix the configuration's
  generator reads;
- ``portbench/end_to_end/<metric>.py`` and ``portbench/layers/<metric>.py``:
  the reader of an end-to-end or per-layer metric (``read(ctx)``, None
  where it finds nothing), the metric's name with ``.`` and ``-``
  written as ``_``.

A run: set-up (imports, the port's library load or build, the inputs
made on the card from the seed and held pinned on the host as an ingest
ring, the entry, a warm-up over every block of the ring), then a window
of ``seconds`` in which the entry takes blocks as fast as it goes (a
closed loop), then, with ``trace``, the entry's stage split and a
profiled span; then the reference on a sample of the window's blocks
drawn from the seed, and the result line.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")
WARM_CYCLES = 2           # warm-up passes over the ring
SPLIT_BLOCKS = 6          # blocks of the traced run's stage split
PROFILE_BLOCKS = 6        # blocks of the traced run's profiled span


class HarnessError(RuntimeError):
    """The run cannot give a result (no card, a forbidden module, a
    name that resolves to no file)."""


# -- names to files ------------------------------------------------------------
def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    path = os.path.join(PKG, *parts)
    if not os.path.isfile(path):
        raise HarnessError(f"no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def module_name(metric: str) -> str:
    return metric.replace(".", "_").replace("-", "_")


def resolve(spec: dict, workload: str) -> SimpleNamespace:
    """The cell ``workload`` of ``spec`` with its configuration, traffic
    mix, entry and reference modules, and its metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = _json("configs", f"{cell['config']}.json")
    if os.path.normpath(os.path.join(ROOT, cfg_entry["file"])) != \
            os.path.normpath(os.path.join(PKG, "configs",
                                          f"{cell['config']}.json")):
        raise HarnessError(f"config {cell['config']}: file "
                           f"{cfg_entry['file']} is not its own")
    mix = _json("traffic", f"{cell['traffic']}.json")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]
    return SimpleNamespace(
        cell=cell, cfg=cfg, mix=mix,
        inputs=_module("inputs", cfg["inputs"]),
        entry=_module("entries", cfg["entry"]),
        reference=_module("reference", cfg["reference"]),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def _module(folder: str, name: str):
    if not os.path.isfile(os.path.join(PKG, folder, f"{name}.py")):
        raise HarnessError(f"no file portbench/{folder}/{name}.py")
    return importlib.import_module(f"portbench.{folder}.{name}")


def reader(metric: str, folder: str = "layers"):
    """The ``read(ctx)`` of a metric in ``portbench/<folder>/``."""
    return _module(folder, module_name(metric)).read


# -- the process -----------------------------------------------------------------
def process_start_wall() -> float:
    """The wall-clock time this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return time.time() - up + start_ticks / os.sysconf("SC_CLK_TCK")


# -- the run's bookkeeping ---------------------------------------------------------
class Source:
    """Blocks of the ring in turn, numbered, until a deadline or a count."""

    def __init__(self, ring, first: int, deadline: float | None = None,
                 count: int | None = None):
        self.ring, self.seq = ring, first
        self.deadline, self.left = deadline, count

    def next(self):
        if self.left is not None:
            if self.left <= 0:
                return None
            self.left -= 1
        if self.deadline is not None and time.perf_counter() >= \
                self.deadline:
            return None
        seq = self.seq
        self.seq += 1
        return seq, self.ring[seq % len(self.ring)]


class Recorder:
    """Hand-off and completion times of every block, the names of the
    entry's ranges, and a sample drawn from the seed (reservoir sampling
    over the window's blocks, plus the run's first block, the entry's
    start) of what the program produced: what the entry gives before
    and after the call that advances its state, and the output."""

    def __init__(self, seed: int, n_sample: int):
        self.t_hand: dict[int, float] = {}
        self.t_done: dict[int, float] = {}
        self.kept: dict[int, dict] = {}
        self.rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
        self.n_sample = n_sample
        self.window_first: int | None = None
        self.n_seen = 0
        self.sampling = True
        self.spans = False
        self.ranges: set[str] = set()

    def handoff(self, seq: int) -> None:
        self.t_hand[seq] = time.perf_counter()

    def done(self, seq: int, output) -> None:
        self.t_done[seq] = time.perf_counter()
        if seq in self.kept:
            self.kept[seq]["output"] = output

    def _keep(self, seq: int) -> bool:
        if not self.sampling:
            return False
        if seq == 0:
            return True
        if self.window_first is None or seq < self.window_first:
            return False
        self.n_seen += 1
        window = [s for s in self.kept if s != 0]
        if len(window) < self.n_sample:
            return True
        j = int(self.rng.integers(self.n_seen))
        if j < self.n_sample:
            del self.kept[sorted(window)[j]]
            return True
        return False

    def before(self, seq: int, entry) -> None:
        if self._keep(seq):
            self.kept[seq] = entry.sample_in()

    def after(self, seq: int, entry) -> None:
        if seq in self.kept:
            self.kept[seq].update(entry.sample_out())

    def span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        import torch
        self.ranges.add(name)
        return torch.profiler.record_function(name)


# -- one run -----------------------------------------------------------------------------
def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def prepare(workload: str, seed: int, device=None, spec: dict | None = None,
            overrides=None, mix_overrides=None, on_ready=None
            ) -> SimpleNamespace:
    """A run's set-up: the cell resolved, the ring made from the seed,
    the entry built and warmed up over the ring.  ``device`` None takes
    the card and fails without one; ``overrides`` and ``mix_overrides``
    replace keys of the configuration and of the traffic mix (the tests'
    small sizes); ``on_ready(entry)`` is called once the entry is built,
    before the warm-up."""
    import torch

    spec = load_spec() if spec is None else spec
    w = resolve(spec, workload)
    cfg = dict(w.cfg, **(overrides or {}))
    w.mix = dict(w.mix, **(mix_overrides or {}))
    if device is None:
        if not torch.cuda.is_available():
            raise HarnessError("no CUDA device: torch.cuda.is_available() "
                               "is False")
        need = int(w.cell["chips"])
        if torch.cuda.device_count() < need:
            raise HarnessError(f"the cell asks for {need} cards, PyTorch "
                               f"sees {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    ring, infos = w.inputs.make_ring(cfg, w.mix, seed, device, pin=cuda)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    entry = w.entry.Entry(cfg, device)
    if on_ready is not None:
        on_ready(entry)
    rec = Recorder(seed, int(cfg.get("sample_blocks", 3)))
    n_warm = WARM_CYCLES * len(ring)
    t2 = time.perf_counter()
    entry.run(Source(ring, 0, count=n_warm), rec)
    sync()
    t3 = time.perf_counter()
    log(f"set-up: inputs {t1 - t0:.3f} s, entry {t2 - t1:.3f} s, warm-up "
        f"over {n_warm} blocks {t3 - t2:.3f} s")
    rec.window_first = n_warm
    return SimpleNamespace(w=w, cfg=cfg, device=device, cuda=cuda,
                           sync=sync, ring=ring, infos=infos, entry=entry,
                           rec=rec, n_warm=n_warm)


def samples(ring, infos, kept) -> list[SimpleNamespace]:
    """The sampled blocks, in order: each its ``seq``, input ``block``,
    what the generator put in it (``info``) and what the program gave
    (``kept``)."""
    return [SimpleNamespace(seq=s, block=ring[s % len(ring)],
                            info=infos[s % len(ring)], kept=kept[s])
            for s in sorted(kept)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, spec: dict | None = None, overrides=None,
             mix_overrides=None, t_proc: float | None = None,
             on_ready=None) -> dict:
    """One run of ``workload``; returns the result object.  The
    arguments after ``trace`` are :func:`prepare`'s; ``t_proc`` is the
    process's start (wall clock)."""
    import torch
    from portbench import compare, guard, hostinfo
    from portbench import trace as tr

    t_proc = process_start_wall() if t_proc is None else t_proc
    log(f"set-up: process start to the harness's imports done "
        f"{time.time() - t_proc:.3f} s")
    found = guard.forbidden()
    if found:
        raise HarnessError(f"forbidden modules loaded: {found}")
    run = prepare(workload, seed, device, spec, overrides, mix_overrides,
                  on_ready)
    w, cfg, device, cuda, sync = run.w, run.cfg, run.device, run.cuda, \
        run.sync
    ring, infos, entry, rec = run.ring, run.infos, run.entry, run.rec
    n_warm = run.n_warm
    del run

    # -- the window ------------------------------------------------------------------
    host0 = hostinfo.snapshot()
    t_start = time.perf_counter()
    setup_s = time.time() - t_proc
    deadline = t_start + seconds
    src = Source(ring, n_warm, deadline=deadline)
    entry.run(src, rec)
    sync()
    host1 = hostinfo.snapshot()
    handed = [s for s in rec.t_hand if s >= n_warm]
    done = sorted(s for s in handed if s in rec.t_done
                  and rec.t_done[s] <= deadline)
    host = hostinfo.window(host0, host1, len(handed))
    host["card"] = hostinfo.card(device.index or 0) if cuda else None
    if not done:
        raise HarnessError(f"no block completed in the {seconds} s window")
    t_last = max(rec.t_done[s] for s in done)
    lat = [rec.t_done[s] - rec.t_hand[s] for s in done]
    ctx = SimpleNamespace(
        cfg=cfg, channels=entry.channels, block_s=entry.block_s,
        setup_s=setup_s, split={}, span=None, kernel_shapes={},
        window=SimpleNamespace(latencies=lat, span_s=t_last - t_start,
                               handed=len(handed)))
    step_ms = 1e3 * (t_last - t_start) / len(done)
    log(f"window: {len(handed)} blocks handed off, {len(done)} completed "
        f"in {seconds} s; {step_ms:.3f} ms a block; latency over "
        f"{len(done)} blocks: median {1e3 * float(np.median(lat)):.3f} ms, "
        f"p95 {np.percentile(lat, 95) * 1e3:.3f} ms; set-up "
        f"{setup_s:.3f} s")
    log(f"host in the window: {json.dumps(host)}")
    for s in [s for s in rec.kept if s != 0 and s not in done]:
        del rec.kept[s]

    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": int(w.cell["chips"])}
    breakdown = None
    if not trace:
        for m in w.end_to_end:
            metrics[m["name"]] = {
                "value": float(reader(m["name"], "end_to_end")(ctx)),
                "unit": m["unit"]}
    else:
        rec.sampling = False
        nxt = src.seq
        for i in range(SPLIT_BLOCKS):
            for k, v in entry.split(ring[(nxt + i) % len(ring)]).items():
                ctx.split.setdefault(k, []).append(v)
        nxt += SPLIT_BLOCKS
        rec.spans = True
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            entry.run(Source(ring, nxt, count=PROFILE_BLOCKS), rec)
            sync()
            span_s = time.perf_counter() - t0
        rec.spans = False
        ctx.kernel_shapes = entry.kernel_shapes()
        ctx.span = tr.summarize(prof, PROFILE_BLOCKS, span_s, rec.ranges)
        log(f"profiled span: {PROFILE_BLOCKS} blocks in {span_s:.3f} s "
            f"({1e3 * span_s / PROFILE_BLOCKS:.3f} ms a block under the "
            f"profiler, {step_ms:.3f} ms unprofiled in the window); device "
            f"busy {ctx.span.busy_s:.4f} s")
        for m in w.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info["busy_s"] = ctx.span.busy_s
        device_info["window_s"] = span_s
        breakdown = tr.breakdown(ctx.span)
    device_info["memory_peak_bytes"] = int(
        torch.cuda.max_memory_allocated(device) if cuda else 0)

    # -- the comparison, once the window has closed and the program's
    # state is freed ---------------------------------------------------------------------
    kept = rec.kept
    del entry, rec, ctx
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, n_failed, notes = w.reference.Reference(cfg, device).judge(
        samples(ring, infos, kept))
    ok, checks = compare.judge(numbers, cfg["limits"])
    log(f"compared blocks {sorted(kept)} (the first is the entry's start) "
        f"against the reference in {time.perf_counter() - t_ref:.3f} s; "
        f"{json.dumps(notes)}")
    result = {"correct": bool(ok), "attempted": len(handed),
              "failed": n_failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["host"] = host
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return result
