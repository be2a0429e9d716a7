"""Moving-target detection: slow-time Doppler FFT, clutter suppression, MTI, iSTC.

Replicated reference semantics (file:line):

* windowed slow-time FFT per range bin, ``fftshift``, magnitude —
  ``MTD/fun_Process_MTD.m:17-36`` (the reference loops over range bins; here
  one batched FFT over the pulse axis handles every range bin, beam and slice
  at once);
* zero-velocity notch: rows ``round(N/2) +- round(N/divisor)`` (1-based) set
  to zero — ``MTD/fun_0v_pressing.m:18-22`` (divisor 150) and the G1 variant
  ``CFAR_WangCai/fun_0v_pressing.m:5`` (divisor 20);
* G0 unshifted notch: rows ``[1:k+1, N-k+1:N]`` —
  ``DMX_SignalProcessing_main_xzr.m:462-465``;
* MTI: 30-pulse-lag two-pulse canceller ``x[n+30] - x[n]`` —
  ``MTD/fun_Process_MTI.m:20-22``;
* iSTC: per-sample gain ``10^(stc/20)`` — ``MTD/fun_iSTC.m:12-15``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from radar_signal_process_tpu.config import matlab_round


def doppler_process(
    pc: jnp.ndarray,
    window: np.ndarray,
    n_fft: int | None = None,
    shift: bool = True,
    magnitude: bool = True,
    pulse_axis: int = -2,
) -> jnp.ndarray:
    """Slow-time FFT over the pulse axis, forming the range-Doppler map.

    ``pc``: (..., n_pulses, n_range) pulse-compressed data.  ``window`` is a
    length-``n_pulses`` slow-time taper (reference ``kaiser(N, 8)``).
    Returns the magnitude RDM (default) matching ``fun_Process_MTD``.

    The non-power-of-two CPI lengths (332, 1536) go to the FFT library as
    they are; XLA fuses the window multiply and the magnitude around it.
    """
    n_pulses = pc.shape[pulse_axis]
    if window.shape[0] != n_pulses:
        raise ValueError(f"window length {window.shape[0]} != n_pulses {n_pulses}")
    w_shape = [1] * pc.ndim
    w_shape[pulse_axis % pc.ndim] = n_pulses
    w = jnp.asarray(window, dtype=jnp.real(pc).dtype).reshape(w_shape)
    spec = jnp.fft.fft(pc * w, n=n_fft or n_pulses, axis=pulse_axis)
    if shift:
        spec = jnp.fft.fftshift(spec, axes=pulse_axis)
    return jnp.abs(spec) if magnitude else spec


def doppler_process_range_major(
    pc: jnp.ndarray,
    window: np.ndarray,
    n_fft: int | None = None,
    shift: bool = True,
) -> jnp.ndarray:
    """``doppler_process`` emitting the RDM in (..., n_range, n_velocity) layout.

    Bit-identical to ``doppler_process(pc, window).mT`` for (..., pulse,
    range) inputs.  On XLA CPU the pulse-axis FFT internally works in
    range-major order, so asking for the transposed result directly skips a
    materialized transpose, and the downstream CFAR runs its velocity-dim
    pass along the contiguous axis (~2x the cascade throughput; see
    ``segmented_cfar_flags(transposed=True)``).
    """
    n_pulses = pc.shape[-2]
    if window.shape[0] != n_pulses:
        raise ValueError(f"window length {window.shape[0]} != n_pulses {n_pulses}")
    w = jnp.asarray(window, dtype=jnp.real(pc).dtype)[:, None]
    spec = jnp.matrix_transpose(jnp.fft.fft(pc * w, n=n_fft or n_pulses, axis=-2))
    if shift:
        spec = jnp.fft.fftshift(spec, axes=-1)
    return jnp.abs(spec)


def zero_velocity_notch(rdm: jnp.ndarray, half_width: int | None = None,
                        divisor: int = 150, velocity_axis: int = -2) -> jnp.ndarray:
    """Zero the Doppler rows around the (shifted) zero-velocity position.

    The reference centers the notch on 1-based row ``round(N/2)`` (0-based
    ``round(N/2) - 1``) with half-width ``round(N/divisor)``
    (``fun_0v_pressing.m:18-22``).  Static-shape mask, fused by XLA.
    """
    n = rdm.shape[velocity_axis]
    hw = matlab_round(n / divisor) if half_width is None else half_width
    center = matlab_round(n / 2) - 1
    idx = np.arange(n)
    keep = ~((idx >= center - hw) & (idx <= center + hw))
    shape = [1] * rdm.ndim
    shape[velocity_axis] = n
    mask = jnp.asarray(keep.reshape(shape), dtype=rdm.dtype)
    return rdm * mask


def zero_velocity_notch_unshifted(
    rdm: jnp.ndarray, n_clutter: int, velocity_axis: int = -2
) -> jnp.ndarray:
    """G0-style clutter zeroing on an *unshifted* spectrum.

    Zeroes rows ``[0 : n_clutter+1]`` and ``[N-n_clutter : N]`` (0-based),
    replicating ``zeroSetFlagMTD = [1:MTD_0_num+1, mtd_FFT_num-MTD_0_num+1 :
    mtd_FFT_num]`` (``DMX_SignalProcessing_main_xzr.m:463-465``).
    """
    n = rdm.shape[velocity_axis]
    idx = np.arange(n)
    keep = ~((idx <= n_clutter) | (idx >= n - n_clutter))
    shape = [1] * rdm.ndim
    shape[velocity_axis] = n
    mask = jnp.asarray(keep.reshape(shape), dtype=rdm.dtype)
    return rdm * mask


def mti_cancel(echo: jnp.ndarray, lag: int = 30, pulse_axis: int = -2) -> jnp.ndarray:
    """Two-pulse canceller with a ``lag``-pulse baseline.

    ``out[n] = x[n+lag] - x[n]`` for ``n < N-lag``; trailing ``lag`` rows are
    zero (``fun_Process_MTI.m:20-22``).
    """
    echo = jnp.moveaxis(echo, pulse_axis, -2)
    n = echo.shape[-2]
    diff = echo[..., lag:, :] - echo[..., : n - lag, :]
    out = jnp.concatenate([diff, jnp.zeros_like(echo[..., : lag, :])], axis=-2)
    return jnp.moveaxis(out, -2, pulse_axis)


def istc_compensate(echo: jnp.ndarray, stc_curve_db: np.ndarray | jnp.ndarray) -> jnp.ndarray:
    """Inverse-STC gain compensation along the fast-time axis.

    The STC curve (dB) is zero-padded/truncated to the fast-time length and
    applied as ``echo * 10^(stc/20)`` per sample (``fun_iSTC.m:6-15``).
    """
    n = echo.shape[-1]
    stc = jnp.asarray(stc_curve_db, dtype=jnp.real(echo).dtype).reshape(-1)
    if stc.shape[0] < n:
        stc = jnp.concatenate([stc, jnp.zeros(n - stc.shape[0], dtype=stc.dtype)])
    else:
        stc = stc[:n]
    return echo * (10.0 ** (stc / 20.0))
