"""Per-call audio segmentation + export (WAV + JSON sidecar).

The rebuild's analog of the reference's per-call WAV writer with
auto-rename on call end (src/engine/engine.c:2494-2516) and the
rdio-scanner style per-call upload queue (src/app_control/
rdio_export.c); here the export target is a local directory, and
an ``io.rdio.RdioUploader`` set as ``uploader`` posts each finished
call.

The port's own copy of ``dsdneo_tpu/core/calls.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class CallRecord:
    start_s: float
    end_s: float = 0.0
    slot: int = 0
    talkgroup: int = 0
    source: int = 0
    system: str = ""
    mode: str = ""
    audio: list = field(default_factory=list)   # float PCM chunks @8k

    def duration_s(self) -> float:
        return sum(len(c) for c in self.audio) / 8000.0


class CallRecorder:
    """Groups emitted audio into calls (gap-based segmentation) and
    exports each finished call as ``TG<id>_<n>.wav`` + ``.json``."""

    def __init__(self, out_dir: str, gap_s: float = 1.5, mode: str = ""):
        self.out_dir = out_dir
        self.gap_s = gap_s
        self.mode = mode
        self.active: dict[int, CallRecord] = {}
        self.finished: list[CallRecord] = []
        os.makedirs(out_dir, exist_ok=True)
        # continue numbering past existing exports: a fresh counter
        # would silently overwrite TG<id>_0001.wav from a previous run
        # in the same directory
        self._n = 0
        for name in os.listdir(out_dir):
            if name.startswith("TG") and name.endswith(".wav"):
                try:
                    self._n = max(self._n,
                                  int(name[:-4].rsplit("_", 1)[1]))
                except (IndexError, ValueError):
                    pass

    def add_audio(self, pcm, slot: int, t_s: float, talkgroup: int = 0,
                  source: int = 0) -> None:
        call = self.active.get(slot)
        if call is not None and t_s - call.end_s > self.gap_s:
            self.finish(slot)
            call = None
        if call is None:
            call = CallRecord(start_s=t_s, slot=slot, mode=self.mode)
            self.active[slot] = call
        call.audio.append(pcm)
        call.end_s = t_s
        if talkgroup:
            call.talkgroup = talkgroup
        if source:
            call.source = source

    def finish(self, slot: int) -> CallRecord | None:
        call = self.active.pop(slot, None)
        if call is None or not call.audio:
            return None
        self._export(call)
        self.finished.append(call)
        return call

    def finish_all(self) -> None:
        for slot in list(self.active):
            self.finish(slot)

    def _export(self, call: CallRecord) -> None:
        import numpy as np
        from dsdneo_tpu_torch.io.audio_files import write_wav
        self._n += 1
        stem = f"TG{call.talkgroup}_{self._n:04d}"
        wav = os.path.join(self.out_dir, stem + ".wav")
        write_wav(wav, np.concatenate(call.audio), 8000)
        meta = {
            "talkgroup": call.talkgroup,
            "source": call.source,
            "slot": call.slot,
            "mode": call.mode,
            "start_s": round(call.start_s, 3),
            "duration_s": round(call.duration_s(), 3),
            "audio_file": os.path.basename(wav),
        }
        meta_path = os.path.join(self.out_dir, stem + ".json")
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2)
            f.write("\n")
        # optional rdio-scanner upload hook (io.rdio.RdioUploader):
        # the upload meta uses the Rdio-Scanner field names
        # (start_time/stop_time/freq/srcList — io.rdio.write_rdio_meta,
        # the reference's dsd_rdio_write_meta_json format), NOT the
        # local sidecar's record format
        if getattr(self, "uploader", None) is not None:
            import time as _time
            from dsdneo_tpu_torch.io.rdio import write_rdio_meta
            dur = call.duration_s()
            rdio_path = os.path.join(self.out_dir, stem + ".rdio.json")
            write_rdio_meta(
                rdio_path, start_time=_time.time() - dur,
                stop_time=_time.time(), talkgroup=call.talkgroup,
                source=call.source,
                freq_hz=int(getattr(call, "freq_hz", 0) or 0),
                system=call.system or self.mode)
            self.uploader.submit(wav, rdio_path)
