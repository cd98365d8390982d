"""Build and load the port's hand-written kernels and its host decoder.

Every ``csrc/*.cu`` file compiles with ONE ``nvcc -shared`` call for
Hopper (``sm_90a``) into ONE shared library with a plain C interface,
loaded with ``ctypes``:
pointers go as ``c_void_p``, the stream is PyTorch's current stream,
and each C entry point returns ``cudaGetLastError()`` after its launch.
No source includes PyTorch's headers, so a build takes seconds.

``csrc/*.cpp`` is host code (the ADPCM decoder of the PCM fetch, the
C library's float32 trigonometry for the CPU path of the timing
recovery, and the live path's ingest ring), compiled by the host C++
compiler into a second library (:func:`load_host`).

Both build at first use into ``dsdneo_tpu_torch/build/`` (gitignored),
named by a hash of their sources and flags, so an edited source never
loads a stale library; the compiler's output stays beside each
(``.so.log``), so the resource report outlives the build.  Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C entry points of the card library: name → argtypes (each returns int,
# a cudaError_t)
_SIGNATURES = {
    # xr, xi, row stride, column stride, interleaved, taps, ntaps, out,
    # C, B, stream
    "dsd_fir_disc": [_P, _P, _L, _L, _I, _P, _I, _P, _I, _I, _P],
    # T, w0, L, K, V, act, prev_logm, prev_L, w0_out, voiced, amps,
    # f_logm, f_L, C, Tn, pred_decay, amp_scale, stream
    "dsd_imbe_pred": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, ctypes.c_float, ctypes.c_float, _P],
    # pcm, step_table, index_table, out, S, T, stream
    "dsd_adpcm_enc": [_P, _P, _P, _P, _I, _I, _P],
    # words, table (fec.device.k7_table), out, N, n, nroots, stream
    "dsd_rs_syndromes": [_P, _P, _P, _I, _I, _I, _P],
    # llr or bits, hard (1: uint8 bits), bits, cost, N, stream
    "dsd_p25_trellis": [_P, _I, _P, _P, _I, _P],
    # sym, wt, wt row stride (0 or 2n), bits, N, n, stream
    "dsd_conv_k5": [_P, _P, _I, _P, _I, _I, _P],
    # bits, out, N, n, stream
    "dsd_conv_k3": [_P, _P, _I, _I, _P],
    # x, out, R, T, a, b, a2, b2, mode (0 y, 1 x - y, 2 the cascade),
    # state ([R, 2] or null), stream
    "dsd_one_pole": [_P, _P, _I, _I, _F, _F, _F, _F, _I, _P, _P],
}
# host library: name → (argtypes, restype)
_HOST_SIGNATURES = {
    # blob, n_streams, n_bytes, out
    "dsd_adpcm_decode": ([_P, _L, _L, _P], None),
    # x, out, n
    "dsd_cosf": ([_P, _P, _L], None),
    "dsd_sinf": ([_P, _P, _L], None),
    # y, x, out, n
    "dsd_atan2f": ([_P, _P, _P, _L], None),
    # the live path's ingest ring (csrc/ingest_ring.cpp)
    "dsd_ring_create": ([ctypes.c_size_t], _P),
    "dsd_ring_destroy": ([_P], None),
    "dsd_ring_write": ([_P, ctypes.c_char_p, ctypes.c_size_t],
                       ctypes.c_size_t),
    # ring, out [n, 2] f32, n, rotate (0, +1, -1), timeout ms
    "dsd_ring_read_widen_cu8": ([_P, _P, ctypes.c_size_t, _I, _I],
                                ctypes.c_size_t),
    "dsd_ring_purge": ([_P], None),
    "dsd_ring_shutdown": ([_P], None),
    "dsd_ring_drops": ([_P], ctypes.c_uint64),
    "dsd_ring_fill": ([_P], ctypes.c_size_t),
    "dsd_ring_generation": ([_P], ctypes.c_uint32),
    "dsd_set_ftz_daz": ([_I], _I),
}


class _Lib:
    """A loaded library and what its build printed (for the card
    library: registers, shared memory and spills per kernel from
    ``-Xptxas -v``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cdll = None
        self.path = None
        self.build_s = None
        self.build_log = ""


_LIB = _Lib()
_HOST = _Lib()


def _sources(*patterns: str) -> list[str]:
    return sorted(s for p in patterns
                  for s in glob.glob(os.path.join(CSRC, p)))


def _find(env: str, *names: str) -> str:
    for cand in (os.environ.get(env), *names):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError(f"no compiler found (set {env} or put one of "
                       f"{', '.join(names)} on PATH)")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(flags: list[str], srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    """Run a compiler; raise with its log if it fails, else return it."""
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({p.returncode}):\n{p.stdout}")
    return p.stdout


def _build(lib: _Lib, name: str, flags: list[str], srcs: list[str],
           make) -> str:
    """Build ``srcs`` into ``build/<name>_<hash>.so`` unless it exists.
    ``make(out)`` compiles the library to ``out`` in a scratch directory
    and returns the compiler's output, which is kept beside the library
    (``.so.log``) and read back when a later process finds it built; the
    directory goes whatever happens, and the library appears under its
    name only when it is whole, its log already beside it."""
    so = os.path.join(BUILD_DIR, f"{name}_{_digest(flags, srcs)}.so")
    t0 = time.perf_counter()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, "lib.so")
            lib.build_log = make(out)
            with open(os.path.join(tmp, "log"), "w") as f:
                f.write(lib.build_log)
            os.replace(os.path.join(tmp, "log"), so + ".log")
            os.replace(out, so)
    else:
        try:
            with open(so + ".log") as f:
                lib.build_log = f.read()
        except FileNotFoundError:
            lib.build_log = ""
    lib.build_s = time.perf_counter() - t0
    return so


def load():
    """The kernels' ctypes library, compiled on first call by one
    ``nvcc -shared`` over every source."""
    with _LIB.lock:
        if _LIB.cdll is not None:
            return _LIB.cdll
        nvcc = _nvcc()
        cus = _sources("*.cu")
        so = _build(_LIB, "libdsdneo_kernels", NVCC_FLAGS,
                    _sources("*.cu", "*.cuh"),
                    lambda out: _run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                                      out, *cus]))
        cdll = ctypes.CDLL(so)
        for fn_name, args in _SIGNATURES.items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB.path = so
        _LIB.cdll = cdll
        return cdll


def load_host():
    """The host library (``csrc/*.cpp``), compiled on first call with the
    host C++ compiler (``$CXX``, else ``c++`` or ``g++``).  Raises when
    it cannot be built."""
    with _HOST.lock:
        if _HOST.cdll is not None:
            return _HOST.cdll
        cxx = _find("CXX", "c++", "g++")
        srcs = _sources("*.cpp")
        so = _build(_HOST, "libdsdneo_host", CXX_FLAGS, srcs,
                    lambda out: _run([cxx, *CXX_FLAGS, "-o", out, *srcs]))
        cdll = ctypes.CDLL(so)
        for fn_name, (args, res) in _HOST_SIGNATURES.items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = args
            fn.restype = res
        _HOST.path = so
        _HOST.cdll = cdll
        return cdll


def build_info() -> dict:
    """Build seconds (~0 if the library was already built), library
    path, and the compiler's per-kernel resource report (this build's,
    or the one kept beside a library built before)."""
    load()
    return {"seconds": _LIB.build_s, "path": _LIB.path,
            "log": _LIB.build_log}


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Each kernel's resources from ``-Xptxas -v`` output: mangled entry
    name → ``registers``, ``stack`` (bytes of stack frame, i.e. local
    memory), ``spill_stores`` and ``spill_loads`` (bytes)."""
    out: dict[str, dict[str, int]] = {}
    entry = props = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = out.setdefault(m.group(1), {})
        elif m := re.search(r"Function properties for (\S+)", line):
            props = out.get(m.group(1))
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            if props is not None:
                props.update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry \
                is not None:
            entry["registers"] = int(m.group(1))
    return out


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t: torch.Tensor, name: str,
            dtype: torch.dtype | tuple[torch.dtype, ...],
            shape: tuple | None = None, contiguous: bool = True) -> None:
    """The wrapper's input checks: a CUDA tensor of ``dtype`` (or of one
    of a tuple of them) and ``shape``, where given, contiguous unless the
    kernel takes strides."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
