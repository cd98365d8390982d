"""The readings that the limits of ``correct`` are set from.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        [--control-seeds 3] [--blocks 12]

For each seed, in one process: the cell's set-up (inputs, entry,
warm-up over the ring), then ``--blocks`` blocks through the entry at
the cell's own load, with the same sample of blocks kept as a run keeps.
It prints, per seed, the comparison's numbers for the program (the
lower readings) and, on the first ``--control-seeds`` seeds, for the
control: the reference in the precision below the configuration's, put
in the program's place (the upper readings).  Beside them: the largest
gap between the program's soft symbols (its front end alone) and the
reference's on the sampled blocks, which the reference's marginal window
is set from, and the frames that window leaves out.  The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness


def soft_gap(entry, ref, smp) -> float:
    """The largest |program − reference| soft symbol over the samples."""
    import torch
    worst = 0.0
    for s in smp:
        with torch.no_grad():
            a = entry.soft_symbols(s.block).float()
            b = ref.soft_symbols(s.block).to(a.device, torch.float32)
        worst = max(worst, float((a - b).abs().max()))
        del a, b
    return worst


def readings(workload: str, seed: int, n_blocks: int, control: bool,
             device=None, overrides=None, mix_overrides=None) -> dict:
    """The program's numbers (and the control's, where ``control``) on
    ``n_blocks`` blocks after the warm-up, for one seed."""
    import torch
    run = harness.prepare(workload, seed, device, overrides=overrides,
                          mix_overrides=mix_overrides)
    run.entry.run(harness.Source(run.ring, run.n_warm, count=n_blocks),
                  run.rec)
    run.sync()
    w, cfg, dev = run.w, run.cfg, run.device
    smp = harness.samples(run.ring, run.infos, run.rec.kept)
    out = {"seed": seed, "blocks": [s.seq for s in smp]}
    ref = w.reference.Reference(cfg, dev)
    if hasattr(run.entry, "soft_symbols"):
        out["soft_gap"] = soft_gap(run.entry, ref, smp)
    del run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["program"], _, out["program_notes"] = ref.judge(smp)
    out["reference_s"] = time.perf_counter() - t0
    if control:
        ctl = w.reference.Reference(cfg, dev, control=True)
        got = {s.seq: ctl.outputs(s) for s in smp}
        del ctl
        out["control"], _, out["control_notes"] = ref.judge(smp, got)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=12)
    a = ap.parse_args(argv)
    for i, s in enumerate(int(x) for x in a.seeds.split(",")):
        r = readings(a.workload, s, a.blocks, i < a.control_seeds)
        print(json.dumps({"workload": a.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
