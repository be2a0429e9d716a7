"""ctypes binding for the native CPU CFAR cascade, with build-on-demand.

Native CFAR for the CPU host production path: ``native/cfar.cpp`` computes
the cascaded 2-D CFAR (transposed layout) in one pass over a ~4 MB working
set, bit-identical to the jitted split form
(``ops.cfar.segmented_cfar_flags`` + ``segmented_cfar_select``), where XLA
CPU streams ~9.6 GB per G2 frame through the same math.  Build/caching
follows ``ingest/native_loader.py``: compiled on first use to a
content-hash-named ``.so`` (never committed; dlopen caches by path, so a
rebuild under the same name could pin a stale image).

When no toolchain is available (or ``RSP_NATIVE_CFAR=0``) callers fall
back to the jitted split detector — ``native_cfar_available()`` gates it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

from radar_signal_process_tpu.config import CFARConfig, matlab_round

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_NATIVE_DIR, "cfar.cpp")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _lib_path() -> str:
    import hashlib

    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_NATIVE_DIR, f"libcfar-{digest}.so")


def _build(lib_path: str) -> Optional[str]:
    # -ffp-contract=off: no float op sequence may drift from the XLA scalar
    # chain (the parity contract is bit-exactness)
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-std=c++17", "-o", lib_path, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        return f"build failed: {proc.stderr[-2000:]}"
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rsp_cfar_cascade_t.restype = ctypes.c_int
    lib.rsp_cfar_cascade_t.argtypes = [
        ctypes.POINTER(ctypes.c_float),                  # rdm
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # n_r, n_v, n_clutter
        ctypes.POINTER(ctypes.c_uint8),                  # notch mask / NULL
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,  # v cfg
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,  # r cfg
        ctypes.c_int, ctypes.c_int,                      # range_detect, ext
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,      # segs, n_segs
        ctypes.POINTER(ctypes.c_uint8),                  # flags out
        ctypes.POINTER(ctypes.c_uint8),                  # vflags out
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    lib_path = _lib_path()
    if not os.path.exists(lib_path):
        _build_error = _build(lib_path)
        if _build_error:
            return None
    try:
        _lib = _bind(ctypes.CDLL(lib_path))
    except (OSError, AttributeError) as e:
        _build_error = f"library unusable: {e}"
        return None
    return _lib


def native_cfar_available() -> bool:
    return os.environ.get("RSP_NATIVE_CFAR", "1") != "0" and _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def notch_mask_shifted(n_velocity: int, divisor: int) -> np.ndarray:
    """Per-column 1=zero mask of ``ops.mtd.zero_velocity_notch``."""
    hw = matlab_round(n_velocity / divisor)
    center = matlab_round(n_velocity / 2) - 1
    idx = np.arange(n_velocity)
    return ((idx >= center - hw) & (idx <= center + hw)).astype(np.uint8)


def notch_mask_unshifted(n_velocity: int, n_clutter: int) -> np.ndarray:
    """Per-column mask of ``ops.mtd.zero_velocity_notch_unshifted``."""
    idx = np.arange(n_velocity)
    return ((idx <= n_clutter) | (idx >= n_velocity - n_clutter)).astype(
        np.uint8
    )


def make_native_cascade(
    n_clutter: int,
    cfg: CFARConfig,
    cfg_range: CFARConfig | None = None,
    segments: Sequence[Tuple[int, int]] = (),
    notch_mask: np.ndarray | None = None,
):
    """Native cascade over ONE transposed RDM: (n_r, n_v) -> (flags, vflags).

    Bit-identical to ``stage_flags``+``stage_select`` of
    ``models.detect.make_split_detector(transposed=True)`` with the same
    renotch (pass the matching ``notch_mask``).  ``segments`` are row
    (range-axis) bounds; empty means full width.  The returned callable is
    thread-safe (the C side is reentrant) and releases the GIL during
    compute, so the streaming work-queue threads overlap in C++.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native CFAR unavailable: {_build_error}")
    cfg_r = cfg_range or cfg
    mask = None
    if notch_mask is not None:
        mask = np.ascontiguousarray(np.asarray(notch_mask, np.uint8))

    def cascade(rdm_t) -> Tuple[np.ndarray, np.ndarray]:
        a = np.ascontiguousarray(np.asarray(rdm_t, np.float32))
        if a.ndim != 2:
            raise ValueError(f"expected a 2-D transposed RDM, got {a.shape}")
        n_r, n_v = a.shape
        segs = list(segments) or [(0, n_r)]
        for start, stop in segs:
            # the C side indexes rows by these bounds unchecked
            if not 0 <= start < stop <= n_r:
                raise ValueError(
                    f"segment ({start}, {stop}) outside the {n_r}-row RDM"
                )
        seg_arr = np.ascontiguousarray(
            np.asarray(segs, np.int32).reshape(-1)
        )
        if mask is not None and mask.shape[0] != n_v:
            raise ValueError(
                f"notch mask length {mask.shape[0]} != n_velocity {n_v}"
            )
        flags = np.empty((n_r, n_v), np.uint8)
        vflags = np.empty((n_r, n_v), np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.rsp_cfar_cascade_t(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_r, n_v, n_clutter,
            mask.ctypes.data_as(u8p) if mask is not None else None,
            cfg.ref_cells, cfg.guard_cells, cfg.method,
            ctypes.c_float(cfg.threshold),
            cfg_r.ref_cells, cfg_r.guard_cells, cfg_r.method,
            ctypes.c_float(cfg_r.threshold),
            int(cfg.range_detect), cfg.range_extend_cells,
            seg_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(segs),
            flags.ctypes.data_as(u8p), vflags.ctypes.data_as(u8p),
        )
        if rc != 0:
            raise RuntimeError(f"rsp_cfar_cascade_t failed with code {rc}")
        return flags.view(bool), vflags.view(bool)

    return cascade
