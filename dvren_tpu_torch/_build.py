"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<hash>/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libdvren_kernels_<hash>.so _build/<hash>/*.o

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
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (argtypes, restype) per C entry point (see csrc/*.cu)
_SIGNATURES = {
    "dvt_packed_table": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "dvt_tile_forward": ([_P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F,
                          _F, _F, _F, _F, _F, _F, _F, _F, _F,
                          _P], _I),
    "dvt_tile_backward": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I,
                           _F, _F, _F, _F, _F,
                           _F, _F, _F, _F, _F, _F, _F, _F, _F,
                           _F, _F, _F,
                           _P], _I),
    "dvt_packed_table_grad": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "dvt_packed_table16": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "dvt_packed_table16_grad": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "dvt_hash_forward": ([_P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F,
                          _P, _P], _I),
    "dvt_hash_backward": ([_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I,
                           _F, _F, _F, _F, _F,
                           _P, _P], _I),
    "dvt_hash_grid_forward": ([_P] * 8
                              + [_I] * 8
                              + [_F] * 5 + [_F] * 9
                              + [_P, _P], _I),
    "dvt_hash_grid_backward": ([_P] * 11
                               + [_I] * 8
                               + [_F] * 5 + [_F] * 9
                               + [_P, _P], _I),
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
    work = _OUT / f".tmp_{digest}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [work / f"{s.stem}.o" for s in srcs]
    cmds = [[nvcc] + _ARCH + _FLAGS + ["-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, out)
              for c, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} (exit {rc})\n{out}" for c, rc, out in failed))
    tmp = work / "lib.so"
    link = [nvcc] + _ARCH + ["-shared", "-o", str(tmp)] + [str(o) for o in objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed (exit {proc.returncode}):\n{' '.join(link)}\n"
            f"{proc.stderr}{proc.stdout}")
    build_seconds = time.perf_counter() - t0
    (_OUT / f"ptxas_{digest}.txt").write_text("".join(outs))
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
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
