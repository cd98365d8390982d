"""MBE glue: the vocoder behavior contract around parameter decode.

The reference delegates this to mbelib-neo (src/core/vocoder/dsd_mbe.c
store_process_result → mbe_synthesizeSilencef; the classic mbelib
process contract): frames whose ECC error count exceeds the per-codec
threshold REPEAT the last good parameter set, a bounded number of
times, after which the stream goes SILENT until a clean frame arrives;
non-voice (tone) codes synthesize dual/single tones instead of MBE
voice.  Per-stream error accounting mirrors the reference's
p25_p1_voice_err_hist ring (dsd_mbe.c update_p25_p1_voice_err_hist).

Tone synthesis uses the OP25-derived formula the reference ships
(src/core/audio/dsd_audio2.c:1290 soft_tonef): freq = 31.25 Hz · ID,
amplitude = AD · 75 / 8000.

Tone-frame FIELD layout note: the IMBE/AMBE vocoder payloads here are
empirical reconstructions (PARITY.md), so the in-band tone index and
amplitude positions are part of that reconstruction: IMBE tone frames
(raw b0 code in [208, 219]) carry ID at S[12:19], repeated at
S[19:26], AD at S[26:33]; AMBE+2 tone frames (pitch field b0 == 0x7F)
carry ID at b[7:14], AD at b[14:21], ID again at b[21:28].  The ID
redundancy keeps the random-noise false-positive rate ≤ 2^-7 per
non-voice code hit; non-voice codes failing it route through the
corrupt-frame (repeat/silence) path.

The port's own copy of ``dsdneo_tpu/vocoder/glue.py``; its rendering
calls the port's ``vocoder.synth.synthesize_frames``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

TONE_FREQ_STEP_HZ = 31.25        # dsd_audio2.c soft_tonef
TONE_AMP_STEP = 75.0

IMBE_ERR_THRESHOLD = 5           # classic mbelib processImbe4400Dataf
AMBE_ERR_THRESHOLD = 3           # classic mbelib processAmbe2450Dataf
MAX_REPEAT = 3                   # bounded frame repeat before muting

N_SAMPLES = 160                  # 20 ms at 8 kHz


def synthesize_tone(tone_id: int, amp_id: int, n0: int = 0
                    ) -> tuple[np.ndarray, int]:
    """One 160-sample tone frame (OP25 soft_tonef formula); ``n0``
    carries the rolling phase index across frames.  Returns
    (pcm float32 [160], next n0)."""
    freq = TONE_FREQ_STEP_HZ * float(tone_id)
    step = 2.0 * np.pi * freq / 8000.0
    amp = float(amp_id) * TONE_AMP_STEP / 8000.0
    n = n0 + np.arange(N_SAMPLES, dtype=np.float64)
    pcm = (amp * np.sin(n * step)).astype(np.float32)
    return pcm, n0 + N_SAMPLES


IMBE_TONE_B0_MIN = 208           # tone-code band of the raw b0 code
IMBE_TONE_B0_MAX = 219           # (codes above are invalid non-voice)


def imbe_raw_b0(bits88: np.ndarray) -> int:
    """Raw (unclipped) b0 code from the 88-bit parameter frame."""
    from dsdneo_tpu_torch.vocoder.imbe import B0_HI_POS, B0_LO_POS
    S = np.asarray(bits88, dtype=np.uint8)
    b0 = int(sum(int(S[p]) << (7 - i) for i, p in enumerate(B0_HI_POS)))
    return b0 | (int(S[B0_LO_POS[0]]) << 1) | int(S[B0_LO_POS[1]])


def imbe_tone_info(bits88: np.ndarray) -> tuple[int, int] | None:
    """IMBE tone detection: raw b0 in the tone-code band [208, 219]
    with the tone ID carried redundantly (S[12:19] == S[19:26], AD at
    S[26:33]) → (tone_id, amp_id).  Non-voice codes that fail the
    redundancy check are INVALID frames — callers route them through
    the corrupt-frame (repeat/silence) path, the classic-mbelib
    process-failure behavior."""
    S = np.asarray(bits88, dtype=np.uint8)
    b0 = imbe_raw_b0(S)
    if not (IMBE_TONE_B0_MIN <= b0 <= IMBE_TONE_B0_MAX):
        return None
    tone_id = int(sum(int(S[12 + i]) << (6 - i) for i in range(7)))
    tone_id2 = int(sum(int(S[19 + i]) << (6 - i) for i in range(7)))
    if tone_id != tone_id2:
        return None
    amp_id = int(sum(int(S[26 + i]) << (6 - i) for i in range(7)))
    return max(tone_id, 1), amp_id


def ambe_tone_info(bits49: np.ndarray) -> tuple[int, int] | None:
    """AMBE+2 tone-frame detection: pitch field b0 == 0x7F (an
    out-of-range pitch) AND the tone ID repeated at b[21:28] (tone
    frames carry the ID redundantly; the repeat also keeps the random-
    noise false-positive rate at 2^-14) → (tone_id, amp_id)."""
    b = np.asarray(bits49, dtype=np.uint8)
    b0 = int(sum(int(b[i]) << (6 - i) for i in range(7)))
    if b0 != 0x7F:
        return None
    tone_id = int(sum(int(b[7 + i]) << (6 - i) for i in range(7)))
    tone_id2 = int(sum(int(b[21 + i]) << (6 - i) for i in range(7)))
    if tone_id != tone_id2:
        return None
    amp_id = int(sum(int(b[14 + i]) << (6 - i) for i in range(7)))
    return max(tone_id, 1), amp_id


@dataclass
class MbeGlue:
    """Per-voice-stream frame conditioning + error accounting."""

    err_threshold: int = IMBE_ERR_THRESHOLD
    max_repeat: int = MAX_REPEAT
    hist_len: int = 50               # p25_p1_voice_err_hist length

    last_good: object = None         # last clean MbeFrame
    repeat: int = 0
    tone_n: int = 0                  # rolling tone phase
    err_hist: list = field(default_factory=list)
    total_errs: int = 0
    muted_frames: int = 0
    tone_frames: int = 0

    def account(self, errs: int) -> None:
        self.err_hist.append(int(errs))
        if len(self.err_hist) > self.hist_len:
            self.err_hist.pop(0)
        self.total_errs += int(errs)

    def err_avg(self) -> float:
        return float(np.mean(self.err_hist)) if self.err_hist else 0.0

    def condition(self, frame, errs: int, tone: tuple[int, int] | None):
        """One decoded frame → a render directive:

        ("tone", (id, ad))   — non-voice code: synthesize the tone
        ("voice", frame)     — clean frame (resets the repeat counter)
        ("repeat", frame)    — errors over threshold: last good params
        ("silence", None)    — repeat budget exhausted (or no good
                               frame yet): mute this frame
        """
        self.account(errs)
        if tone is not None:
            self.tone_frames += 1
            self.repeat = 0
            return ("tone", tone)
        if errs > self.err_threshold:
            self.repeat += 1
            if self.repeat <= self.max_repeat and self.last_good is not None:
                return ("repeat", self.last_good)
            self.muted_frames += 1
            return ("silence", None)
        self.repeat = 0
        self.last_good = frame
        return ("voice", frame)

    def render(self, directives, device=None) -> np.ndarray:
        """Render a directive list to concatenated 8 kHz PCM: voice and
        repeat frames batch through the harmonic synthesizer on
        ``device`` (the card when none is given); tone frames use the
        OP25 formula with rolling phase; silence is zeros."""
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        voice = [fr for kind, fr in directives if kind in ("voice", "repeat")]
        vpcm = (synthesize_frames(voice, device) if voice
                else np.zeros(0, np.float32))
        out = np.zeros(N_SAMPLES * len(directives), dtype=np.float32)
        vi = 0
        for i, (kind, arg) in enumerate(directives):
            seg = slice(N_SAMPLES * i, N_SAMPLES * (i + 1))
            if kind in ("voice", "repeat"):
                out[seg] = vpcm[N_SAMPLES * vi:N_SAMPLES * (vi + 1)]
                vi += 1
            elif kind == "tone":
                out[seg], self.tone_n = synthesize_tone(arg[0], arg[1],
                                                        self.tone_n)
            # silence: stays zero
        return out
