"""Rehearse the serial decode path's streams on the CPU.

    python tools/rehearse_serial.py [mode ...]

``engine.decoder.decode_samples(..., device="cpu")`` on each named 60 s
stream of ``data/serial_tables.npz`` (by default the two of M17 and
P25p2, the latter also blind), and ``detect_mode`` on a 4 s probe of
each family's stream, printing for each the wall time split as
``chip_smoke.py``'s serial phase splits it on the card: the front end
(``demod_fm``), the synthesis (``synthesize_frames``, and M17's Codec2
host calls) with its call count, and the host walk (the rest).  These are
CPU times of this machine, a rehearsal for a card run's prediction, not
a device measurement.  It imports no JAX.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dsdneo_tpu_torch.engine import decoder as sdec  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.vocoder import codec2, synth  # noqa: E402


def main(argv: list[str]) -> int:
    tv = SV.vector()
    spent = {"front": 0.0, "synth": 0.0, "calls": 0}

    def timed(key, fn):
        def wrap(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
                spent["calls"] += key == "synth"
        return wrap

    sdec.demod_fm = timed("front", sdec.demod_fm)
    synth.synthesize_frames = timed("synth", synth.synthesize_frames)
    codec2.Codec2.decode = timed("synth", codec2.Codec2.decode)
    streams = {
        "m17": (lambda: SV.m17_iq(tv), {"state_attrs": SV.m17_attrs(tv)}),
        "p25p2": (lambda: SV.p2_iq(tv), {"p2_params": SV.p2_params(tv)}),
        "p25p2_blind": (lambda: SV.p2_iq(tv), {})}
    for name in argv or list(streams):
        make, kw = streams[name]
        for k in spent:
            spent[k] = 0
        t = time.perf_counter()
        SV.decode_spied(make(), name.split("_")[0], device="cpu",
                        keyring=SV.keyring(tv), **kw)
        wall = time.perf_counter() - t
        print(f"{name}: 60 s in {wall:.2f} s on the CPU; front end "
              f"{spent['front']:.2f} s, synthesis {spent['synth']:.2f} s "
              f"({spent['calls']} calls), host walk "
              f"{wall - spent['front'] - spent['synth']:.2f} s", flush=True)
    probes = {"p25p1": lambda: SV.p25_iq(tv, 4 * 4800),
              "provoice": lambda: SV.pv_iq(tv, 4 * 9600),
              "dmr": lambda: SV.dmr_iq(tv, 4 * 4800),
              "x2tdma": lambda: SV.x2_iq(tv, 4 * 6000),
              "nxdn48": lambda: SV.nxdn_iq(tv, 4 * 2400, "nxdn48"),
              "nxdn96": lambda: SV.nxdn_iq(tv, 4 * 4800, "nxdn96"),
              "dpmr": lambda: SV.dpmr_iq(tv, 4 * 2400),
              "ysf": lambda: SV.ysf_iq(tv, 4 * 4800),
              "dstar": lambda: SV.dstar_iq(tv, 4 * 4800),
              "m17": lambda: SV.m17_iq(tv, 4 * 4800),
              "p25p2": lambda: SV.p2_iq(tv, 4 * 6000)}
    total = 0.0
    for fam, make in probes.items():
        x = make()
        t = time.perf_counter()
        pick = sdec.detect_mode(x, device="cpu").name
        total += time.perf_counter() - t
        print(f"detect_mode on 4 s of {fam}: {pick} "
              f"({time.perf_counter() - t:.2f} s on the CPU)", flush=True)
    print(f"detect_mode on the 11 probes: {total:.2f} s on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
