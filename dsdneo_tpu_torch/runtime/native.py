"""The live path's ingest ring and the FPU's flush-to-zero switch.

The port's own counterpart of ``dsdneo_tpu/runtime/native.py``'s
``IngestRing`` and ``set_ftz_daz``: the same C source
(``csrc/ingest_ring.cpp``, a copy of the JAX package's
``native/ingest_ring.cpp``), compiled into the port's host library
(``kernels.load_host``, in the gitignored ``build/``) at first use.  The
ring is the SPSC seam between an I/Q source thread (rtl_tcp, USB, a
replay feeder) and the decode loop (the reference's input ring,
include/dsd-neo/runtime/input_ring.h): bytes in, whole blocks of float32
I/Q planes out, widened from CU8 with an optional fs/4 rotation, with
drop accounting and a purge generation for retunes.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dsdneo_tpu_torch import kernels


def set_ftz_daz(enable: bool = True) -> bool:
    """DSD_NEO_FTZ_DAZ: flush-to-zero/denormals-are-zero on the calling
    thread (x86 MXCSR; returns False where unsupported or when the host
    library cannot be built)."""
    try:
        return bool(kernels.load_host().dsd_set_ftz_daz(1 if enable else 0))
    except (OSError, RuntimeError):
        return False


class IngestRing:
    """SPSC byte ring with CU8→float block framing."""

    def __init__(self, capacity: int = 1 << 22):
        self._lib = kernels.load_host()
        self._h = self._lib.dsd_ring_create(capacity)
        self._dangle = b""      # odd trailing byte held for next write

    def write(self, data: bytes | np.ndarray) -> int:
        """Producer side.  The ring carries CU8 sample pairs, but TCP
        sources deliver arbitrary chunk sizes: an odd byte is kept here
        and put before the next write, so the ring only ever sees whole
        samples (and a truncated write can only drop whole samples,
        never flip the I/Q byte parity)."""
        buf = bytes(data) if not isinstance(data, bytes) else data
        if self._dangle:
            buf = self._dangle + buf
            self._dangle = b""
        if len(buf) & 1:
            self._dangle = buf[-1:]
            buf = buf[:-1]
        if not buf:
            return 0
        return self._lib.dsd_ring_write(self._h, buf, len(buf))

    def read_block_cu8(self, n_samples: int, rotate: int = 0,
                       timeout_ms: int = 1000) -> np.ndarray | None:
        """Blocking read of one framed block → float32 [n, 2] I/Q planes;
        None on timeout or purge."""
        out = np.empty((n_samples, 2), dtype=np.float32)
        got = self._lib.dsd_ring_read_widen_cu8(
            self._h, out.ctypes.data_as(ctypes.c_void_p), n_samples,
            rotate, timeout_ms)
        if got < n_samples:
            return None
        return out

    def purge(self) -> None:
        self._lib.dsd_ring_purge(self._h)

    def shutdown(self) -> None:
        self._lib.dsd_ring_shutdown(self._h)

    @property
    def drops(self) -> int:
        return self._lib.dsd_ring_drops(self._h)

    @property
    def fill(self) -> int:
        return self._lib.dsd_ring_fill(self._h)

    @property
    def generation(self) -> int:
        return self._lib.dsd_ring_generation(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.dsd_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
