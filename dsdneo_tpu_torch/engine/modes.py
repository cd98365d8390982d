"""Decode mode matrix: protocol family → DSP configuration.

The port's own copy of ``dsdneo_tpu/engine/modes.py`` (pure Python):
each decode mode selects a channel-filter profile (the name of its taps
in ``data/tdma_tables.npz``, or the ``dsp.firdes.channel_lpf`` profile
the front end designs), a symbol rate, the slicer's arity and the
frame-sync families the serial decode path hunts (reference mode table
src/io/radio/rtl_demod_config.cpp; docs/rtl-demod-pipeline-audit.md:36-50).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModeConfig:
    name: str
    flag: str                  # reference CLI flag (-f1, -fs, ...)
    lpf_profile: str
    symbol_rate: int
    four_level: bool
    protocols: frozenset[str]  # framesync pattern families to hunt

    @property
    def sps(self) -> float:
        return 48000.0 / self.symbol_rate


def _m(name, flag, lpf, rate, four, protos):
    return ModeConfig(name, flag, lpf, rate, four, frozenset(protos))


MODES: dict[str, ModeConfig] = {m.name: m for m in [
    _m("p25p1", "-f1", "p25_c4fm", 4800, True, {"p25p1"}),
    _m("p25p2", "-f2", "p25_c4fm", 6000, True, {"p25p2"}),
    _m("dmr", "-fs", "12k5", 4800, True, {"dmr"}),
    _m("nxdn48", "-fi", "6k25", 2400, True, {"nxdn"}),
    _m("nxdn96", "-fn", "12k5", 4800, True, {"nxdn"}),
    _m("dpmr", "-fm", "6k25", 2400, True, {"dpmr"}),
    _m("dstar", "-fd", "6k25", 4800, False, {"dstar"}),
    _m("ysf", "-fy", "12k5", 4800, True, {"ysf"}),
    _m("edacs", "-fh", "provoice", 9600, False, {"edacs", "provoice"}),
    _m("provoice", "-fp", "provoice", 9600, False, {"provoice", "edacs"}),
    _m("m17", "-fz", "12k5", 4800, True, {"m17"}),
    _m("x2tdma", "-fx", "12k5", 6000, True, {"x2tdma"}),
    _m("auto", "-fa", "wide", 4800, True,
       {"p25p1", "dmr", "nxdn", "dstar", "ysf", "dpmr", "m17", "x2tdma"}),
]}

FLAG_TO_MODE = {m.flag: m.name for m in MODES.values()}
