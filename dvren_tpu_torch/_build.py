"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/libdvren_kernels_<hash>.so \
         csrc/*.cu

The build runs at the first kernel launch in a process, never at import,
and lands in ``dvren_tpu_torch/_build/`` (git-ignored), keyed by a hash of
the sources and flags: an unchanged tree loads the library it built
before. ``-Xptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (:func:`ptxas_report`).

No ``--use_fast_math``: the kernels are held to their plain PyTorch twins
at 5e-6, and fast math would swap ``expf`` for an approximation.

Calling convention: every pointer and the CUDA stream are ``c_void_p``;
each entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (argtypes, restype) per C entry point (see csrc/*.cu)
_SIGNATURES = {
    "dvt_packed_table": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "dvt_tile_forward": ([_P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I,
                          _F, _F, _F, _F, _F,
                          _F, _F, _F, _F, _F, _F, _F, _F, _F,
                          _P], _I),
    "dvt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None
_lib_path = None
build_seconds = None   # wall time of this process's build (None: none ran)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (CUDA_HOME unset and no nvcc on PATH): "
            "the port's kernels cannot be built")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _digest() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _build() -> Path:
    global build_seconds
    import time

    digest = _digest()
    lib = _OUT / f"libdvren_kernels_{digest}.so"
    if lib.exists():
        return lib
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = _OUT / f".tmp_{digest}_{os.getpid()}.so"
    cmd = ([_nvcc()] + _ARCH + _FLAGS + ["-o", str(tmp)]
           + [str(s) for s in _sources() if s.suffix == ".cu"])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    build_seconds = time.perf_counter() - t0
    (_OUT / f"ptxas_{digest}.txt").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = _build()
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib, _lib_path = lib, path
        return _lib


def ptxas_report() -> str:
    """ptxas's per-kernel register / shared-memory / spill report for the
    loaded library ("" before the first build)."""
    if _lib_path is None:
        return ""
    digest = _lib_path.stem.rsplit("_", 1)[-1]
    report = _OUT / f"ptxas_{digest}.txt"
    return report.read_text() if report.exists() else ""


def check(code: int, what: str) -> None:
    """Raise if a kernel launch returned a nonzero ``cudaError_t``."""
    if code != 0:
        text = library().dvt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {text}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
