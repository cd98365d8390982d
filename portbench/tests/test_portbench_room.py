"""A configuration and its cell join the benchmark as new files and
appended entries of ``BENCHMARK.json`` alone.

In a copy of ``portbench/`` and ``BENCHMARK.json`` (the port beside it
through a link), the test adds a 4-channel P25 configuration under a new
name that reuses today's generator, entry and reference, a traffic mix,
a cell, and a per-layer metric with a reader of its own that applies to
that cell alone; it touches no file already there.  In the copy, the
spec tests pass, the new cell resolves with the card's busy and idle
metrics and the new one, and a traced run of it on the CPU is correct
and reads the new metric.  Nothing is written into the repository."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

CONFIG = "p25p1_c4fm_4"
MIX = "p25_keyed_small"
CELL = "p25_4.keyed"
METRIC = "pick_decode_spans_ms"
READER = '''"""``pick_decode_spans_ms``: host milliseconds a block in the P25
pipeline's pick and decode spans, over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.pick", "p25.decode_enqueue",
                            blocks="p25.blocks")
'''
# what the copy's harness gives the new cell, and a traced run of it
PROBE = f'''
import json
import torch
from portbench import harness
from portbench.tests.test_portbench_correct import SEED, small
torch.set_num_threads(2)
spec = harness.load_spec()
w = harness.resolve(spec, {CELL!r})
cells = {{c["name"]: [m["name"] for m in
                     harness.resolve(spec, c["name"]).per_layer]
         for c in spec["workloads"]}}
cfg, mix = small({CELL!r})
r = harness.run_cell({CELL!r}, SEED + 9, 3.0, True, device="cpu",
                     overrides=cfg, mix_overrides=mix)
print(json.dumps({{"end_to_end": [m["name"] for m in w.end_to_end],
                  "per_layer": cells, "result": r}}))
'''


def _env():
    return dict(os.environ, PYTHONDONTWRITEBYTECODE="1")


def _write(path, obj):
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj, indent=2))


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The copy, with the new configuration's files and entries added."""
    root = tmp_path_factory.mktemp("room")
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("BENCHMARK.json", "pytest.ini"):
        shutil.copy(os.path.join(harness.ROOT, f), root / f)
    os.symlink(os.path.join(harness.ROOT, "dsdneo_tpu_torch"),
               root / "dsdneo_tpu_torch")
    pkg = root / "portbench"
    spec = harness.load_spec()
    base = spec["configs"][0]
    with open(os.path.join(harness.ROOT, base["file"])) as f:
        cfg = json.load(f)
    cfg.update(name=CONFIG, channels=4,
               small={"block_s": 0.5, "sample_blocks": 1})
    _write(pkg / "configs" / f"{CONFIG}.json", cfg)
    _write(pkg / "traffic" / f"{MIX}.json", {
        "ring": 2, "keyed": {"all": True}, "lead_dibits": [0, 256],
        "why": "every channel keyed", "small": {}})
    _write(pkg / "layers" / f"{harness.module_name(METRIC)}.py", READER)
    spec["configs"].append({
        "name": CONFIG, "source": cfg["source"],
        "file": f"portbench/configs/{CONFIG}.json", "reduced": [],
        "why": "four P25 channels through today's entry"})
    spec["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
        "why": "four channels all keyed, closed loop"})
    spec["per_layer"].append({
        "name": METRIC, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "pick and voice decode",
        "moves": "realtime_x", "workloads": [CELL]})
    _write(root / "BENCHMARK.json", spec)
    return root


def test_the_copy_only_adds(room):
    """Every file of the benchmark is in the copy as it is, and
    ``BENCHMARK.json`` keeps every entry, the new ones appended."""
    for d, _s, files in os.walk(harness.PKG):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), harness.PKG)
            assert filecmp.cmp(os.path.join(d, f), room / "portbench" / rel,
                               shallow=False), rel
    old = harness.load_spec()
    new = harness.load_spec(str(room))
    assert set(new) == set(old)
    for k in ("configs", "workloads", "per_layer"):
        assert new[k][:len(old[k])] == old[k] and \
            len(new[k]) == len(old[k]) + 1, k
    for k in set(old) - {"configs", "workloads", "per_layer"}:
        assert new[k] == old[k], k


def test_the_copys_spec_tests_pass(room):
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--basetemp", str(room / "_pytest"),
         "portbench/tests/test_portbench_spec.py"],
        cwd=room, capture_output=True, text=True, timeout=600, env=_env())
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]


def test_the_new_cell_resolves_and_runs(room):
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=room,
                       capture_output=True, text=True, timeout=600,
                       env=_env())
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(out["end_to_end"]) == {"realtime_x", "setup_s"}
    assert set(out["per_layer"][CELL]) == {"device_busy_ms",
                                           "device_idle_pct", METRIC}
    for cell, names in out["per_layer"].items():
        assert {"device_busy_ms", "device_idle_pct"} <= set(names)
        assert (METRIC in names) == (cell == CELL)
    r = out["result"]
    assert r["correct"], r["checks"]
    # the CPU has no device timeline, so only the new metric reads here
    assert set(r["metrics"]) == {METRIC}
    assert r["metrics"][METRIC]["value"] > 0
