"""Detection stage: RDM -> cascaded CFAR flags -> padded detection list.

Replicates the stage-3 driver behavior (``CFAR_WangCai/main_cfar.m:85-96``):
the RDM magnitude is re-notched with the wide G1 clutter notch and the
cascaded 2-D CFAR runs per pulse segment.  ``n_clutter`` follows
``MTD_0v_num = floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from radar_signal_process_tpu.config import CFARConfig, RadarProfile
from radar_signal_process_tpu.ops.cfar import (
    segmented_cfar,
    segmented_cfar_flags,
    segmented_cfar_select,
)
from radar_signal_process_tpu.ops.measure import DetectionList, extract_detections
from radar_signal_process_tpu.ops.mtd import zero_velocity_notch


def clutter_cells(profile: RadarProfile, n_fft: int, clutter_v: float = 3.0) -> int:
    """``MTD_0_num = floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``)."""
    return int(math.floor(clutter_v / profile.delta_v(n_fft)))


def detect_rdm(
    rdm: jnp.ndarray,
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = 20,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RDM (..., n_v, n_r) -> (cascade flags, velocity-only flags).

    One executable with the roll-form cascade (``ops.cfar.segmented_cfar``);
    the device path on every backend.
    """
    cfg = cfg or profile.cfar
    if renotch_divisor:
        if profile.mtd.fftshift:
            rdm = zero_velocity_notch(rdm, divisor=renotch_divisor)
        else:
            # unshifted spectra (G0) keep clutter at the spectrum edges;
            # the centered notch would erase the highest-Doppler band
            from radar_signal_process_tpu.ops.mtd import (
                zero_velocity_notch_unshifted,
            )

            rdm = zero_velocity_notch_unshifted(rdm, n_clutter)
    segments = profile.cfar_segments or ((0, rdm.shape[-1]),)
    return segmented_cfar(rdm, segments, cfg, n_clutter)


def make_split_detector(
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = 20,
    transposed: bool = False,
):
    """Two-executable CFAR detector for CPU backends.

    XLA CPU re-computes fused producers into every consumer inside a single
    executable (the reference-level chains feed both the flag compare and the
    cascade selection), so the one-executable :func:`detect_rdm` pays ~2.2x
    the necessary work there.  This splits the cascade at the (vflag, rflag)
    materialization point into two jitted executables composed in Python —
    bit-identical outputs, same ``(flags, vflags)`` contract.

    Use inside host-level composition only (it calls ``jax.jit`` internally
    and cannot be traced into an enclosing jit).

    ``transposed=True`` works on (..., n_range, n_velocity) RDMs (the
    ``doppler_process_range_major`` layout) and returns transposed flags —
    the velocity-dim CFAR then runs along the contiguous axis (~2x cascade
    throughput on CPU).
    """
    cfg = cfg or profile.cfar
    v_axis = -1 if transposed else -2
    r_axis = -2 if transposed else -1

    def _notch(rdm):
        if not renotch_divisor:
            return rdm
        if profile.mtd.fftshift:
            return zero_velocity_notch(
                rdm, divisor=renotch_divisor, velocity_axis=v_axis
            )
        from radar_signal_process_tpu.ops.mtd import zero_velocity_notch_unshifted

        return zero_velocity_notch_unshifted(rdm, n_clutter, velocity_axis=v_axis)

    def _segments(rdm):
        return profile.cfar_segments or ((0, rdm.shape[r_axis]),)

    @jax.jit
    def stage_flags(rdm):
        rdm = _notch(rdm)
        return segmented_cfar_flags(
            rdm, _segments(rdm), cfg, n_clutter, transposed=transposed
        )

    @jax.jit
    def stage_select(rdm, vflag, rflag):
        rdm = _notch(rdm)
        return segmented_cfar_select(
            rdm, vflag, rflag, _segments(rdm), cfg, n_clutter,
            transposed=transposed,
        )

    def detect(rdm: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        vflag, rflag = stage_flags(rdm)
        return stage_select(rdm, vflag, rflag)

    return detect


def make_cascade_detector(
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = 20,
    transposed: bool = False,
    prefer_native: bool | None = None,
):
    """:func:`make_split_detector` with an optional native C++ backend.

    The native cascade (``kernels/native/cfar.cpp``) is the third lockstep
    CFAR implementation — bit-identical flags (``tests/test_native_cfar.py``)
    with no XLA in the loop.  On the session host it measures at PARITY with
    the jitted split form, both per item and inside the streaming chain
    (BASELINE.md round 5), so the jitted form stays the default; pass
    ``prefer_native=True`` or set ``RSP_NATIVE_CFAR=1`` to select it (e.g.
    for jax-free CPU serving, or to keep the XLA intra-op pool free).
    Transposed layout only; other layouts use the jitted form.
    """
    import os

    cfg = cfg or profile.cfar
    if prefer_native is None:
        prefer_native = (
            os.environ.get("RSP_NATIVE_CFAR") == "1"
            and transposed
            and jax.default_backend() == "cpu"
        )
    if prefer_native and transposed:
        from radar_signal_process_tpu.kernels.native_cfar import (
            make_native_cascade,
            native_cfar_available,
            notch_mask_shifted,
            notch_mask_unshifted,
        )

        if native_cfar_available():
            mask = None
            if renotch_divisor:
                # Doppler-bin extent: the padded FFT length when the
                # profile zero-pads (G0 class), else the CPI length
                n_v = profile.mtd.fft_length or profile.prt_per_frame
                mask = (
                    notch_mask_shifted(n_v, renotch_divisor)
                    if profile.mtd.fftshift
                    else notch_mask_unshifted(n_v, n_clutter)
                )
            return make_native_cascade(
                n_clutter, cfg, segments=profile.cfar_segments or (),
                notch_mask=mask,
            )
    return make_split_detector(
        profile, n_clutter, cfg=cfg, renotch_divisor=renotch_divisor,
        transposed=transposed,
    )


def make_detector(
    profile: RadarProfile,
    n_clutter: int | None = None,
    clutter_v: float = 3.0,
    max_detections: int = 64,
    renotch_divisor: int | None = 20,
    cfg: CFARConfig | None = None,
):
    """Jitted detector: RDM (n_v, n_r) -> (flags, vflags, DetectionList)."""

    @jax.jit
    def detect(rdm: jnp.ndarray):
        nc = (
            n_clutter
            if n_clutter is not None
            else clutter_cells(profile, rdm.shape[-2], clutter_v)
        )
        flags, vflags = detect_rdm(
            rdm, profile, nc, cfg=cfg, renotch_divisor=renotch_divisor
        )
        dets: DetectionList = extract_detections(flags, rdm, max_detections)
        return flags, vflags, dets

    return detect
