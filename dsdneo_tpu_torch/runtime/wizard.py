"""Interactive bootstrap wizard (reference
src/runtime/bootstrap/interactive.c): a minimal prompt flow that fills
in the decode mode, input source and audio output when the user starts
the CLI with --wizard (or with no input on a tty).  Pure-function core
(prompt I/O injected) so it is testable headless.

The port's own copy of ``dsdneo_tpu/runtime/wizard.py`` (host Python),
unchanged in its logic.
"""

from __future__ import annotations

from dataclasses import dataclass

MODE_CHOICES = [
    ("1", "auto", "auto-detect"),
    ("2", "p25p1", "P25 Phase 1"),
    ("3", "p25p2", "P25 Phase 2"),
    ("4", "dmr", "DMR"),
    ("5", "nxdn48", "NXDN48"),
    ("6", "nxdn96", "NXDN96"),
    ("7", "dpmr", "dPMR"),
    ("8", "dstar", "D-STAR"),
    ("9", "ysf", "System Fusion"),
    ("10", "m17", "M17"),
    ("11", "edacs", "EDACS"),
]


@dataclass
class WizardResult:
    mode: str = "auto"
    iq_replay: str = ""
    audio_out: str = "null"
    stream_s: float = 0.0


def run_wizard(ask, say=lambda *_: None) -> WizardResult:
    """``ask(prompt, default)`` → str; ``say(line)`` for output."""
    out = WizardResult()
    say("dsd-neo-tpu setup wizard")
    say("decode modes:")
    for key, _, label in MODE_CHOICES:
        say(f"  {key}) {label}")
    choice = ask("mode", "1").strip()
    for key, mode, _ in MODE_CHOICES:
        if choice == key or choice == mode:
            out.mode = mode
            break
    out.iq_replay = ask("I/Q capture to replay (.iq/.iq.json)", "").strip()
    out.audio_out = ask("audio output (null | wav:PATH | wav2:PATH | "
                        "pcm:PATH | udp:HOST:PORT)", "null").strip() or "null"
    blk = ask("streamed block seconds (0 = one-shot)", "0").strip()
    try:
        out.stream_s = max(float(blk), 0.0)
    except ValueError:
        out.stream_s = 0.0
    return out
