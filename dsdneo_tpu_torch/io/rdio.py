"""Rdio-Scanner-style HTTP call uploader.

The reference posts each finished call as a multipart/form-data request
with fields key / system / audio (audio/wav) / meta (application/json)
to the configured endpoint, from a background worker with a bounded
retry queue (src/runtime/rdio_export.c:33-41, 724-883).  Same wire
format here via urllib (no libcurl needed), with the same bounded-depth
queue + per-job retry semantics.

The port's own copy of ``dsdneo_tpu/io/rdio.py`` (host Python, urllib),
unchanged in its logic.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request
import uuid


def build_multipart(fields: dict[str, bytes | str],
                    files: dict[str, tuple[str, bytes, str]]
                    ) -> tuple[bytes, str]:
    """→ (body, content_type).  files: name → (filename, data, mime)."""
    boundary = "----dsdneo" + uuid.uuid4().hex
    out = []
    for name, value in fields.items():
        out.append(f"--{boundary}\r\n"
                   f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                   .encode())
        out.append(value.encode() if isinstance(value, str) else value)
        out.append(b"\r\n")
    for name, (fname, data, mime) in files.items():
        out.append(f"--{boundary}\r\n"
                   f'Content-Disposition: form-data; name="{name}"; '
                   f'filename="{fname}"\r\n'
                   f"Content-Type: {mime}\r\n\r\n".encode())
        out.append(data)
        out.append(b"\r\n")
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


class RdioUploader:
    """Background multipart uploader with a bounded retry queue."""

    def __init__(self, endpoint: str, api_key: str, system: str,
                 max_queue: int = 32, retries: int = 2,
                 timeout_s: float = 10.0):
        self.endpoint = endpoint
        self.api_key = api_key
        self.system = system
        self.retries = retries
        self.timeout_s = timeout_s
        self.max_queue = max_queue
        self._q: list[tuple[str, str]] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.uploaded = 0
        self.failed = 0
        self.dropped = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, wav_path: str, meta_path: str) -> bool:
        with self._lock:
            if len(self._q) >= self.max_queue:
                self.dropped += 1
                return False
            self._q.append((wav_path, meta_path))
        self._wake.set()
        return True

    def _upload_once(self, wav_path: str, meta_path: str) -> bool:
        try:
            wav = open(wav_path, "rb").read()
            meta = open(meta_path, "rb").read()
        except OSError:
            return False
        body, ctype = build_multipart(
            {"key": self.api_key, "system": self.system},
            {"audio": (os.path.basename(wav_path), wav, "audio/wav"),
             "meta": (os.path.basename(meta_path), meta,
                      "application/json")})
        req = urllib.request.Request(self.endpoint, data=body,
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return 200 <= r.status < 300
        except (urllib.error.URLError, OSError):
            return False

    def _worker(self) -> None:
        while True:
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            if self._stop and not self._q:
                return
            while True:
                with self._lock:
                    if not self._q:
                        break
                    wav, meta = self._q.pop(0)
                ok = False
                for _ in range(self.retries + 1):
                    if self._upload_once(wav, meta):
                        ok = True
                        break
                if ok:
                    self.uploaded += 1
                else:
                    self.failed += 1

    def close(self, timeout: float = 5.0) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=timeout)


def write_rdio_meta(path: str, *, start_time: float, stop_time: float,
                    talkgroup: int, source: int, freq_hz: int,
                    system: str, talkgroup_tag: str = "") -> None:
    """Write the rdio meta JSON sidecar (field names per the reference's
    dsd_rdio_write_meta_json)."""
    doc = {
        "start_time": int(start_time),
        "stop_time": int(stop_time),
        "talkgroup": int(talkgroup),
        "talkgroup_tag": talkgroup_tag,
        "srcList": [{"pos": 0, "src": int(source)}] if source > 0 else [],
        "freq": int(freq_hz) if freq_hz > 1_000_000 else 0,
        "system": system,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
