"""Each cell for a few seconds on the card, as the benchmark runs it
(``pytest portbench/tests -m cuda`` on a machine with one)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


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
    assert "fir_disc_roofline_pct" in r["metrics"]
    assert 0 < r["metrics"]["fir_disc_roofline_pct"]["value"] <= 100
