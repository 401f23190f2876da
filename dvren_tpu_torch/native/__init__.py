"""The native core: ctypes bindings of ``dvren_native.cpp``.

The port's copy of ``dvren_tpu``'s native library. Its scheduler entries
(``dvn_pack_runs``, ``dvn_build_runs``, ``dvn_tighten_occupancy``) are
the host hot loop of
:func:`~dvren_tpu_torch.render.tiled.build_tiled_schedule`, byte-identical
to its numpy form. Its CPU oracles (:func:`generate_rays`,
:func:`eval_grid`, :func:`integrate`: scalar double precision) are the
independent referee of the pipeline, its packed-ragged views
(:func:`ray_offsets`, :func:`pack_samples`, :func:`unpack_samples`) that
of ``Renderer.packed_samples`` (which masks on the device), and
:func:`write_ppm` that of ``io/ppm.py``. g++
builds it at the first call in a process, never at import:

    g++ -O3 -march=native -ffp-contract=off -shared -fPIC -std=c++17 \
        dvren_native.cpp -o _build/libdvren_native_<hash>.so

``-ffp-contract=off`` keeps the float32 arithmetic equal to numpy's bit
for bit (no fused multiply-add). The library lands in
``dvren_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source,
the flags and the target ``-march=native`` resolves to; it is built in a
directory of its own and moved in with ``os.replace``, so processes that
build at once never write one file.

:func:`enabled` is the selection: ``DVREN_NATIVE_SCHED=0`` picks the numpy
schedule builder, anything else this core. Unlike ``dvren_tpu``, whose
core falls back to numpy when it cannot be built, a failed build raises
(``RuntimeError`` with the compiler's output): :func:`available` is
false only when the numpy route was asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "dvren_native.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
          "-std=c++17"]
ABI_VERSION = 4

_f32p = ctypes.POINTER(ctypes.c_float)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_longlong)
_ll = ctypes.c_longlong
_int = ctypes.c_int
_flt = ctypes.c_float
_long = ctypes.c_long
_SIGNATURES = {
    "dvn_abi_version": ([], _int),
    "dvn_generate_rays": ([_int, _f32p, _f32p, _flt, _int, _int,
                           _int, _int, _int, _int, _flt, _flt,
                           _f32p, _f32p, _f32p, _f32p, _u32p], _int),
    "dvn_eval_grid": ([_f32p, _int, _int, _int, _int, _f32p, _f32p, _int,
                       _int, _f32p, _long, _f32p], _int),
    "dvn_integrate": ([_long, _int, _f32p, _f32p, _f32p, _u8p, _flt, _flt,
                       _f32p, _f32p, _f32p, _f32p, _f32p], _int),
    "dvn_ray_offsets": ([_long, _int, _u8p, _u32p], _long),
    "dvn_pack_samples": ([_long, _int, _int, _u8p, _f32p, _f32p], _long),
    "dvn_unpack_samples": ([_long, _int, _int, _u8p, _f32p, _f32p], _long),
    "dvn_write_ppm": ([ctypes.c_char_p, _f32p, _int, _int], _int),
    "dvn_pack_runs": ([_i64p, _ll, _ll, _int, _ll, _ll, _ll,
                       _i32p, _i32p, _i64p, _i32p, _i32p, _i64p, _i32p],
                      _int),
    "dvn_tighten_occupancy": ([_f32p, _f32p, _i64p, _i64p, _f32p, _ll,
                               _flt, _flt, _flt, _flt, _int, _f32p, _f32p,
                               _int, _int, _int, _u8p, _ll, _i32p, _i32p],
                              _int),
    "dvn_build_runs": ([_f32p, _f32p, _i64p, _u8p, _i64p,
                        _ll, _int, _int, _flt, _flt, _flt, _flt, _int,
                        _f32p, _ll, _ll, _f32p, _f32p,
                        _int, _int, _int, _int, _ll, _ll, _ll, _int,
                        _f32p, _f32p, _i32p, _i32p, _i64p, _i32p, _i32p,
                        _i64p, _i32p], _int),
}

_lock = threading.Lock()
_lib = None
compiler = "g++"     # the compiler the build runs
build_seconds = None   # wall time of this process's build (None: none ran)


def enabled() -> bool:
    """The scheduler uses this core unless ``DVREN_NATIVE_SCHED=0``."""
    return os.environ.get("DVREN_NATIVE_SCHED", "1") != "0"


def available() -> bool:
    """True when this core is selected (:func:`enabled`), after building
    and loading it (a failed build raises); False only under
    ``DVREN_NATIVE_SCHED=0``."""
    if not enabled():
        return False
    library()
    return True


def load_error() -> str | None:
    """Why :func:`available` is false (the numpy route was asked for),
    else None."""
    if enabled():
        return None
    return "DVREN_NATIVE_SCHED=0 selects the numpy route"


def _run(cmd) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(
            f"the native scheduler core cannot be built: {' '.join(cmd)}: "
            f"{exc} (set DVREN_NATIVE_SCHED=0 for the numpy builder)"
        ) from exc


def _digest() -> str:
    """Source, flags and the target ``-march=native`` means on this host
    (a library built for another CPU is not loaded)."""
    target = _run([compiler, "-march=native", "-Q", "--help=target"])
    h = hashlib.sha256()
    h.update(_SRC.read_bytes())
    h.update(" ".join([compiler] + _FLAGS).encode())
    h.update(target.stdout.encode())
    return h.hexdigest()[:16]


def _build() -> Path:
    global build_seconds
    import time

    lib = _OUT / f"libdvren_native_{_digest()}.so"
    if lib.exists():
        return lib
    work = _OUT / f".tmp_native_{os.getpid()}_{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    tmp = work / "lib.so"
    cmd = [compiler] + _FLAGS + [str(_SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = _run(cmd)
    if proc.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(
            f"the native scheduler core failed to build (exit "
            f"{proc.returncode}; set DVREN_NATIVE_SCHED=0 for the numpy "
            f"builder):\n{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            if lib.dvn_abi_version() != ABI_VERSION:
                raise RuntimeError("native scheduler core: ABI mismatch")
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: {rc}")


def generate_rays(model: int, k: np.ndarray, c2w: np.ndarray,
                  ortho_scale: float, width: int, height: int, roi,
                  t_near: float, t_far: float):
    """The double-precision ray generator over the ROI ``(x, y, w, h)``
    (``model`` 0 pinhole, 1 orthographic): (origins (N, 3), directions
    (N, 3), t_near (N,), t_far (N,), pixel ids (N,) uint32)."""
    lib = library()
    n = int(roi[2]) * int(roi[3])
    origins = np.empty((n, 3), np.float32)
    dirs = np.empty((n, 3), np.float32)
    tn = np.empty(n, np.float32)
    tf = np.empty(n, np.float32)
    pids = np.empty(n, np.uint32)
    k = np.ascontiguousarray(k, np.float32).reshape(-1)
    c2w = np.ascontiguousarray(c2w, np.float32).reshape(-1)
    _check(lib.dvn_generate_rays(
        int(model), _ptr(k, _f32p), _ptr(c2w, _f32p), ortho_scale, width,
        height, int(roi[0]), int(roi[1]), int(roi[2]), int(roi[3]), t_near,
        t_far, _ptr(origins, _f32p), _ptr(dirs, _f32p), _ptr(tn, _f32p),
        _ptr(tf, _f32p), _ptr(pids, _u32p)), "dvn_generate_rays")
    return origins, dirs, tn, tf, pids


def eval_grid(grid: np.ndarray, bbox_min, bbox_max, interp: int, oob: int,
              positions: np.ndarray) -> np.ndarray:
    """The grid (nz, ny, nx) or (nz, ny, nx, C) at ``positions`` (..., 3)
    in double precision: (M,) or (M, C) float32."""
    lib = library()
    grid = np.ascontiguousarray(grid, np.float32)
    scalar = grid.ndim == 3
    nz, ny, nx = grid.shape[:3]
    channels = 0 if scalar else grid.shape[3]
    positions = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    n = positions.shape[0]
    out = np.empty((n, max(channels, 1)), np.float32)
    bmin = np.ascontiguousarray(bbox_min, np.float32)
    bmax = np.ascontiguousarray(bbox_max, np.float32)
    _check(lib.dvn_eval_grid(
        _ptr(grid, _f32p), nx, ny, nz, channels, _ptr(bmin, _f32p),
        _ptr(bmax, _f32p), int(interp), int(oob), _ptr(positions, _f32p), n,
        _ptr(out, _f32p)), "dvn_eval_grid")
    return out[:, 0] if scalar else out


def integrate(sigma: np.ndarray, color: np.ndarray, dt: np.ndarray,
              mask: np.ndarray, t_near: float, t_far: float,
              want_aux: bool = False) -> dict:
    """The sequential double-precision integrator of an (N, K) lattice
    (``color`` (N, K, 3)): radiance, transmittance, opacity, depth, and
    with ``want_aux`` the (N, K, 4) aux (alpha, weight, T_before,
    log T_before), zero past each ray's stop."""
    lib = library()
    n, k = sigma.shape
    sigma = np.ascontiguousarray(sigma, np.float32)
    color = np.ascontiguousarray(color, np.float32)
    dt = np.ascontiguousarray(dt, np.float32)
    mask8 = np.ascontiguousarray(mask, np.uint8)
    radiance = np.empty((n, 3), np.float32)
    trans = np.empty(n, np.float32)
    opacity = np.empty(n, np.float32)
    depth = np.empty(n, np.float32)
    aux = np.zeros((n, k, 4), np.float32) if want_aux else None
    _check(lib.dvn_integrate(
        n, k, _ptr(sigma, _f32p), _ptr(color, _f32p), _ptr(dt, _f32p),
        _ptr(mask8, _u8p), t_near, t_far, _ptr(radiance, _f32p),
        _ptr(trans, _f32p), _ptr(opacity, _f32p), _ptr(depth, _f32p),
        _ptr(aux, _f32p) if aux is not None else _f32p()), "dvn_integrate")
    out = dict(radiance=radiance, transmittance=trans, opacity=opacity,
               depth=depth)
    if want_aux:
        out["aux"] = aux
    return out


def ray_offsets(mask: np.ndarray) -> np.ndarray:
    """(N+1,) uint32 prefix offsets of an (N, K) mask's live samples."""
    lib = library()
    n, k = mask.shape
    mask8 = np.ascontiguousarray(mask, np.uint8)
    offsets = np.empty(n + 1, np.uint32)
    lib.dvn_ray_offsets(n, k, _ptr(mask8, _u8p), _ptr(offsets, _u32p))
    return offsets


def pack_samples(mask: np.ndarray, dense: np.ndarray) -> np.ndarray:
    """Dense (N, K) or (N, K, C) values at an (N, K) mask's live slots,
    ray-major: (M,) or (M, C)."""
    lib = library()
    n, k = mask.shape
    scalar = dense.ndim == 2
    channels = 1 if scalar else dense.shape[2]
    mask8 = np.ascontiguousarray(mask, np.uint8)
    dense = np.ascontiguousarray(dense, np.float32)
    total = int(mask8.astype(bool).sum())
    packed = np.empty((total, channels), np.float32)
    got = lib.dvn_pack_samples(n, k, channels, _ptr(mask8, _u8p),
                               _ptr(dense, _f32p), _ptr(packed, _f32p))
    if got != total:
        raise RuntimeError(f"dvn_pack_samples packed {got} of {total}")
    return packed[:, 0] if scalar else packed


def unpack_samples(mask: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """The inverse of :func:`pack_samples`: masked slots are zero."""
    lib = library()
    n, k = mask.shape
    scalar = packed.ndim == 1
    channels = 1 if scalar else packed.shape[1]
    mask8 = np.ascontiguousarray(mask, np.uint8)
    packed = np.ascontiguousarray(packed, np.float32)
    dense = np.empty((n, k, channels), np.float32)
    lib.dvn_unpack_samples(n, k, channels, _ptr(mask8, _u8p),
                           _ptr(packed, _f32p), _ptr(dense, _f32p))
    return dense[..., 0] if scalar else dense


def write_ppm(path: str, image: np.ndarray) -> None:
    """An (H, W, 3) float image as a binary PPM, clamped to [0, 1] and
    rounded to bytes."""
    lib = library()
    image = np.ascontiguousarray(image, np.float32)
    h, w, _ = image.shape
    _check(lib.dvn_write_ppm(os.fsencode(path), _ptr(image, _f32p), w, h),
           "dvn_write_ppm")


def pack_runs(flat: np.ndarray, pitch: int, sentinel: int, umax: int,
              pmax: int):
    """The run-pack scan of every row of ``flat`` (rows, cols) int64 cell
    ids (``render/tiled.py::_pack_runs_numpy``): (lidx, lanes_run, ucell,
    ulane, n_u, upair, n_p)."""
    lib = library()
    flat = np.ascontiguousarray(flat, np.int64)
    rows, cols = flat.shape
    lidx = np.empty((rows, cols), np.int32)
    lanes_run = np.empty(rows, np.int32)
    ucell = np.empty((rows, umax), np.int64)
    ulane = np.empty((rows, umax), np.int32)
    n_u = np.empty(rows, np.int32)
    upair = np.empty((rows, pmax), np.int64)
    n_p = np.empty(rows, np.int32)
    _check(lib.dvn_pack_runs(
        _ptr(flat, _i64p), rows, cols, pitch, sentinel, umax, pmax,
        _ptr(lidx, _i32p), _ptr(lanes_run, _i32p), _ptr(ucell, _i64p),
        _ptr(ulane, _i32p), _ptr(n_u, _i32p), _ptr(upair, _i64p),
        _ptr(n_p, _i32p)), "dvn_pack_runs")
    return lidx, lanes_run, ucell, ulane, n_u, upair, n_p


def build_runs(ot, dtn, safe_ids, live_r, ke, nc, n_sub, t_near, t_far,
               dt, nudge, k_max, jitter, jn, bbox_lo, inv_ext, grid_nxyz,
               pitch, sentinel, umax, pmax, cell_scale=1):
    """The sample lattice of a chunk-count class fused with the run-pack
    scan (``dvn_build_runs``): (st_l, m_l, lidx, lanes_run, ucell, ulane,
    n_u, upair, n_p). At ``cell_scale`` 2 the packed ids are supercell
    ids and each sample's cell-within-supercell bits sit in lidx at bit
    16."""
    lib = library()
    t_cnt = ot.shape[0]
    ot = np.ascontiguousarray(ot, np.float32)
    dtn = np.ascontiguousarray(dtn, np.float32)
    safe_ids = np.ascontiguousarray(safe_ids, np.int64)
    live_u8 = np.ascontiguousarray(live_r, np.uint8)
    ke = np.ascontiguousarray(ke, np.int64)
    nx, ny, nz = grid_nxyz
    rows = t_cnt * nc * n_sub
    sub_cols = (16 // n_sub) * 128
    st_l = np.empty((t_cnt, nc, 16, 128), np.float32)
    m_l = np.empty((t_cnt, nc, 16, 128), np.float32)
    lidx = np.empty((rows, sub_cols), np.int32)
    lanes_run = np.empty(rows, np.int32)
    ucell = np.empty((rows, umax), np.int64)
    ulane = np.empty((rows, umax), np.int32)
    n_u = np.empty(rows, np.int32)
    upair = np.empty((rows, pmax), np.int64)
    n_p = np.empty(rows, np.int32)
    if jitter is not None:
        jit = np.ascontiguousarray(jitter, np.float32)
        jptr, jk = _ptr(jit, _f32p), jit.shape[1]
    else:
        jptr, jk, jn = None, 0, 0
    lo = np.ascontiguousarray(bbox_lo, np.float32)
    inv = np.ascontiguousarray(inv_ext, np.float32)
    _check(lib.dvn_build_runs(
        _ptr(ot, _f32p), _ptr(dtn, _f32p), _ptr(safe_ids, _i64p),
        _ptr(live_u8, _u8p), _ptr(ke, _i64p),
        t_cnt, nc, n_sub, t_near, t_far, dt, nudge, k_max,
        jptr, jn, jk, _ptr(lo, _f32p), _ptr(inv, _f32p),
        nx, ny, nz, pitch, sentinel, umax, pmax, int(cell_scale),
        _ptr(st_l, _f32p), _ptr(m_l, _f32p), _ptr(lidx, _i32p),
        _ptr(lanes_run, _i32p), _ptr(ucell, _i64p), _ptr(ulane, _i32p),
        _ptr(n_u, _i32p), _ptr(upair, _i64p), _ptr(n_p, _i32p)),
        "dvn_build_runs")
    return st_l, m_l, lidx, lanes_run, ucell, ulane, n_u, upair, n_p


def tighten_occupancy(o, d, ke, cnt, jitter, t_near, t_far, dt, nudge,
                      k_max, lo, inv_ext, grid_nxyz, cell_empty):
    """Each ray's window [ke, ke + cnt) trimmed to its first..last step
    whose sample lands in a non-empty cell, scanning forward and then
    backward (``dvn_tighten_occupancy``): (ke, cnt) int32. A ray with no
    such step gets (0, 0)."""
    lib = library()
    n = o.shape[0]
    o = np.ascontiguousarray(o, np.float32)
    d = np.ascontiguousarray(d, np.float32)
    ke = np.ascontiguousarray(ke, np.int64)
    cnt = np.ascontiguousarray(cnt, np.int64)
    if jitter is not None:
        jit = np.ascontiguousarray(jitter, np.float32)
        jptr, jk = _ptr(jit, _f32p), jit.shape[1]
    else:
        jptr, jk = None, 0
    lo = np.ascontiguousarray(lo, np.float32)
    inv = np.ascontiguousarray(inv_ext, np.float32)
    empty_u8 = np.ascontiguousarray(cell_empty, np.uint8)
    nx, ny, nz = grid_nxyz
    ke_out = np.empty(n, np.int32)
    cnt_out = np.empty(n, np.int32)
    _check(lib.dvn_tighten_occupancy(
        _ptr(o, _f32p), _ptr(d, _f32p), _ptr(ke, _i64p), _ptr(cnt, _i64p),
        jptr, jk, t_near, t_far, dt, nudge, k_max,
        _ptr(lo, _f32p), _ptr(inv, _f32p), nx, ny, nz,
        _ptr(empty_u8, _u8p), n, _ptr(ke_out, _i32p),
        _ptr(cnt_out, _i32p)), "dvn_tighten_occupancy")
    return ke_out, cnt_out
