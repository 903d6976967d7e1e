"""Build and load the port's CUDA kernels.

Each ``quest_tpu_torch/csrc/<name>.cu`` is compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
under ``build/quest_tpu_torch/`` at the root of the checkout, and loaded
with ``ctypes``. The library's file name carries a hash of the sources
and flags, so an edited source is rebuilt. A failed build raises; no
caller catches it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code. A source may be built a second
time with preprocessor ``defines`` (an instrumented variant, e.g. the
fused kernel's stage clock), into a library of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "quest_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point and its argument types, per kernel source.
SIGNATURES = {
    "sparse_decode": ("sparse_decode_launch",
                      [_P] * 10 + [_I] * 12 + [_F, _I, _P, _P]),
    "dense_decode": ("dense_decode_launch",
                     [_P] * 8 + [_I] * 10 + [_F, _I, _P, _P]),
    "prefill": ("prefill_launch", [_P] * 6 + [_I] * 10 + [_F, _I, _P, _P]),
    "estimate": ("estimate_launch", [_P] * 4 + [_I] * 7 + [_P]),
    "topk_select": ("topk_select_launch", [_P] * 4 + [_I] * 3 + [_P]),
    "fused_decode": ("fused_decode_launch", [_P] * 8 + [_I] * 12 + [_F, _P]),
    "copy_probe": ("copy_probe_launch", [_P] * 5 + [_I] * 9 + [_P]),
    "select_pieces": ("select_pieces_launch", [_P] * 2 + [_I] * 2 + [_P]),
    # The library's second entry point, dequant_launch, is bound by
    # ops/qdot.py.
    "qgemv": ("qgemv_launch", [_P] * 7 + [_I] * 7 + [_P]),
}
KERNELS = tuple(SIGNATURES)

_libs: Dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc) and an sm_90a card")
    return cand


def _flags(defines: Iterable[str] = ()) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines: tuple = ()) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, defines: tuple = ()):
    """Start nvcc for one source; returns (target, tmp, Popen) or None
    when the library is already built."""
    out = _lib_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> str:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)       # atomic: concurrent builders never see a
    return log                 # half-written library


def build(names: Iterable[str] = KERNELS,
          defines: tuple = ()) -> Dict[str, str]:
    """Build the given kernels, one ``nvcc`` per source, all started
    together. Returns the compiler log (``-Xptxas -v``) per kernel
    built; an up-to-date library is not rebuilt."""
    jobs = {n: _start(n, defines) for n in names}
    try:
        return {n: _finish(n, j) for n, j in jobs.items() if j is not None}
    finally:                   # a failed build stops the other compilers
        for j in jobs.values():
            if j is not None and j[2].poll() is None:
                j[2].kill()
                j[2].wait()


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built with ``defines``),
    built if needed."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            build([name], defines)
            lib = ctypes.CDLL(str(_lib_path(name, defines)))
            lib.qt_error_string.argtypes = [ctypes.c_int]
            lib.qt_error_string.restype = ctypes.c_char_p
            fn, argtypes = SIGNATURES[name]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _libs[(name, defines)] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.qt_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer; NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
