"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with
``ctypes``: pointers go as ``c_void_p``, the stream is PyTorch's current
stream, and each C entry point returns ``cudaGetLastError()`` after its
launch.  No source includes PyTorch's headers, so a build takes seconds.

The library builds at first use into ``dsdneo_tpu_torch/build/``
(gitignored), named by a hash of the sources, so an edited source never
loads a stale library.  Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name → argtypes (all return int, a cudaError_t)
_SIGNATURES = {
    # xr, xi, taps, ntaps, out, C, B, stream
    "dsd_fir_disc": [_P, _P, _P, _I, _P, _I, _I, _P],
    # T, w0, L, K, V, act, prev_logm, prev_L, w0_out, voiced, amps,
    # f_logm, f_L, C, Tn, pred_decay, amp_scale, stream
    "dsd_imbe_pred": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, ctypes.c_float, ctypes.c_float, _P],
    # pcm, step_table, index_table, out, S, T, stream
    "dsd_adpcm_enc": [_P, _P, _P, _P, _I, _I, _P],
}


class _Lib:
    """The loaded library and what its build printed (registers, shared
    memory and spills per kernel from ``-Xptxas -v``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cdll = None
        self.path = None
        self.build_s = None
        self.build_log = ""


_LIB = _Lib()


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load():
    """The kernels' ctypes library, compiled on first call."""
    with _LIB.lock:
        if _LIB.cdll is not None:
            return _LIB.cdll
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + f.read())
        so = os.path.join(BUILD_DIR,
                          f"libdsdneo_kernels_{h.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cu = [s for s in srcs if s.endswith(".cu")]
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                               capture_output=True, text=True)
            _LIB.build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                                   f"{_LIB.build_log}")
            os.replace(tmp, so)
        _LIB.build_s = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB.path = so
        _LIB.cdll = lib
        return lib


def build_info() -> dict:
    """Build seconds (0 if the library was already built), library
    path, and the compiler's per-kernel resource report."""
    load()
    return {"seconds": _LIB.build_s, "path": _LIB.path,
            "log": _LIB.build_log}


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """The wrapper's input checks: a contiguous CUDA tensor of ``dtype``
    (and ``shape``, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
