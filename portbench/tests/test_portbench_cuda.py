"""Each cell for a few seconds on the card, as the benchmark runs it
(``pytest portbench/tests -m cuda`` on a machine with one): correct, the
device's busy time read, and every kernel roofline that applies to the
cell read within (0, 100]."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    got = r["metrics"]
    assert "device_busy_ms" in got
    roof = [m["name"] for m in harness.resolve(SPEC, cell).per_layer
            if "_roofline" in m["name"]]
    assert roof, "no kernel roofline applies to the cell"
    for name in roof:
        assert name in got, name
        assert 0 < got[name]["value"] <= 100, (name, got[name])
