"""G2 MTD pipeline: segmented pulse compression -> Doppler FFT -> clutter notch.

Replicates the stage-2 chain (``MTD/fun_MTD_produce.m:86-102`` composing
``fun_lss_pulse_compression`` -> ``fun_Process_MTD`` -> ``fun_0v_pressing``)
and the windowing driver (``MTD/main_produce_dataset_win_xzr_v2.m:75-136``):
two consecutive frames are concatenated along slow time to double the CPI,
and ``win_size`` overlapping slices are processed per beam.

The reference runs 13 beams x 4 slices = 52 sequential MTD calls per frame.
Here the (beam, slice) axes are plain batch dimensions of one jitted
function — XLA sees a single large batched FFT workload and schedules it
across the device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from radar_signal_process_tpu.config import RadarProfile, matlab_round
from radar_signal_process_tpu.ops.mtd import doppler_process, zero_velocity_notch
from radar_signal_process_tpu.ops.pulse_compression import segmented_pulse_compression
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu.ops.windows import make_window


def _form_rdm(pc: jnp.ndarray, profile: RadarProfile) -> jnp.ndarray:
    """Compressed pulses (..., n_pulses, n_pts) -> notched magnitude RDM.

    The shared RDM-former tail of :func:`mtd_produce` and
    :func:`mtd_window_produce`: slow-time window, Doppler FFT and
    zero-velocity notch.
    """
    n_pulses = pc.shape[-2]
    n_fft = profile.mtd.fft_length or n_pulses
    window = make_window(profile.mtd.window, n_pulses, profile.mtd.window_beta)
    rdm = doppler_process(pc, window, n_fft=n_fft, shift=profile.mtd.fftshift)
    if profile.mtd.notch_divisor:
        rdm = zero_velocity_notch(rdm, divisor=profile.mtd.notch_divisor)
    return rdm


def mtd_produce(
    echo: jnp.ndarray,
    profile: RadarProfile,
    stc_curve_db=None,
    pulses=None,
) -> jnp.ndarray:
    """Echo (..., n_pulses, point_prt) -> magnitude RDM of the same shape.

    The full ``fun_MTD_produce`` chain; reference pulses and the slow-time
    window are compile-time constants derived from ``profile``.  The
    reference's dormant hooks are wired as profile options: iSTC gain
    compensation before compression (``fun_MTD_produce.m:80-81``) and the
    MTI canceller before the Doppler FFT (``fun_Process_MTI.m``).
    ``pulses`` overrides the synthesized matched-filter waveforms (the
    measured-pulse hook, ``fun_MTD_produce.m:72-78`` / ``temp.m:50-56``;
    build with ``ops.waveforms.pulses_with_overrides``).
    """
    from radar_signal_process_tpu.ops.mtd import istc_compensate, mti_cancel

    pulses = reference_pulses(profile) if pulses is None else pulses
    if profile.mtd.istc and stc_curve_db is not None:
        echo = istc_compensate(echo, stc_curve_db)
    pc = segmented_pulse_compression(echo, profile, pulses)
    if profile.mtd.mti_lag:
        pc = mti_cancel(pc, lag=profile.mtd.mti_lag)
    return _form_rdm(pc, profile)


def window_slice_starts(prts_per_slice: int, win_size: int) -> Tuple[int, ...]:
    """Slice start rows: ``round(i * prts / win_size)`` 0-based
    (``main_produce_dataset_win_xzr_v2.m:123``)."""
    return tuple(
        matlab_round(i * prts_per_slice / win_size) for i in range(win_size)
    )


def slice_cpi_window(echo_win: jnp.ndarray, win_size: int) -> jnp.ndarray:
    """(..., 2*n_prt, n_pts) concatenated window -> (..., win_size, n_prt, n_pts)."""
    total = echo_win.shape[-2]
    prts = total // 2
    starts = window_slice_starts(prts, win_size)
    slices = [echo_win[..., s : s + prts, :] for s in starts]
    return jnp.stack(slices, axis=-3)


def mtd_window_produce(
    echo_win: jnp.ndarray,
    profile: RadarProfile,
    win_size: int = 4,
    stc_curve_db=None,
    pulses=None,
) -> jnp.ndarray:
    """Doubled-CPI window (..., 2*n_prt, n_pts) -> (..., win_size, n_prt, n_pts) RDMs.

    Bit-identical to ``mtd_produce(slice_cpi_window(echo_win, win_size))``
    but compresses each PRT row exactly once: pulse compression (and iSTC)
    operate per row along fast time, so running them on the 2*n_prt window
    *before* slicing gives the same rows the reference computes 2x
    redundantly across its overlapping slices
    (``main_produce_dataset_win_xzr_v2.m:120-136``).  MTI, the Doppler FFT
    and the notch remain per-slice (slice-length semantics).
    """
    from radar_signal_process_tpu.ops.mtd import istc_compensate, mti_cancel

    pulses = reference_pulses(profile) if pulses is None else pulses
    if profile.mtd.istc and stc_curve_db is not None:
        echo_win = istc_compensate(echo_win, stc_curve_db)
    pc_win = segmented_pulse_compression(echo_win, profile, pulses)
    pc = slice_cpi_window(pc_win, win_size)         # (..., win, n_prt, n_pts)
    if profile.mtd.mti_lag:
        pc = mti_cancel(pc, lag=profile.mtd.mti_lag)
    return _form_rdm(pc, profile)


def make_frame_processor(
    profile: RadarProfile, win_size: int = 4, stc_curve_db=None, pulses=None
):
    """Jitted processor for one frame pair.

    Returns ``process(frame_now, frame_next)`` mapping two
    ``(n_beams, n_prt, point_prt)`` complex frames to the RDM stack
    ``(n_beams, win_size, n_prt, point_prt)`` — the content of the
    reference's ``MTD_win_all_beams`` cell array
    (``main_produce_dataset_win_xzr_v2.m:109-148``).  ``stc_curve_db``
    activates iSTC compensation when ``profile.mtd.istc`` is set.
    """

    @jax.jit
    def process(frame_now: jnp.ndarray, frame_next: jnp.ndarray) -> jnp.ndarray:
        window = jnp.concatenate([frame_now, frame_next], axis=-2)
        return mtd_window_produce(
            window, profile, win_size, stc_curve_db=stc_curve_db,
            pulses=pulses,
        )

    return process


@functools.partial(jax.jit, static_argnums=(1, 2))
def process_frame_pair(
    frames: jnp.ndarray, profile: RadarProfile, win_size: int = 4
) -> jnp.ndarray:
    """Convenience jitted entry: ``frames`` (2, n_beams, n_prt, point_prt)."""
    window = jnp.concatenate([frames[0], frames[1]], axis=-2)
    return mtd_window_produce(window, profile, win_size)
