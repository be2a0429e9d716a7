"""Pulse compression: matched filtering and narrow-pulse FIR compression.

Design notes
------------
The reference compresses one PRT at a time in a Python-style loop
(``MTD/fun_lss_pulse_compression.m:36-78``).  Here every op operates on the
*last axis* of an arbitrarily-batched array, so a whole frame
(``(n_pulses, n_samples)``) — or a whole beam x slice batch — is compressed
with a handful of large batched FFTs.  FFT lengths are padded to 5-smooth
sizes (linear convolution is exact for any FFT length >= N+M-1), see
:func:`_fft_len`.

Replicated reference semantics (file:line):

* matched filter ``h = conj(fliplr(s0))``, linear-convolution length N+M-1 via
  FFT fast convolution — ``MTD/fun_pulse_compression.m:13-37``;
* alignment: the compressed segment is extracted starting at sample
  ``len(pulse)`` (1-based) of the full convolution —
  ``MTD/fun_lss_pulse_compression.m:57-65``;
* narrow pulse: 35-tap FIR, coefficients normalized by their max, output
  scaled by 1/1.2 and advanced by the filter group delay via a circular
  shift — ``MTD/fun_lss_pulse_compression.m:31-51``;
* G1 range re-concatenation 1031 -> 868 columns —
  ``MatlabProcess_xuzerui/fun_lss_range_concate.m:4-8``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from radar_signal_process_tpu.config import (
    NARROW_PULSE_FIR_TAPS,
    RadarProfile,
)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _next_5smooth(n: int) -> int:
    """Smallest 5-smooth number >= n (fast for pocketfft-class CPU FFTs)."""
    best = _next_pow2(n)
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # round p35 up by powers of two
            p = p35
            while p < n:
                p *= 2
            best = min(best, p)
            p35 *= 3
        p5 *= 5
    return best


def _fft_len(conv_len: int) -> int:
    """FFT length for linear convolution: the smallest 5-smooth size.

    One rule on every backend.  Any length >= conv_len gives exact linear
    convolution, so this only affects speed.  On the CPU, pocketfft is
    fastest at 5-smooth sizes (measured 2.2x on the G2 long segment on a
    2-core sandbox CPU: 3168 vs 4096).  cuFFT also has fast 2/3/5 radices,
    but the GPU length (5-smooth against power of two) is not yet measured.
    """
    return _next_5smooth(conv_len)


def _complex_dtype_like(x) -> jnp.dtype:
    return jnp.complex128 if x.dtype in (jnp.complex128, jnp.float64) else jnp.complex64


def matched_filter_compress(
    echo: jnp.ndarray,
    pulse: np.ndarray | jnp.ndarray,
    extract: bool = True,
) -> jnp.ndarray:
    """Matched-filter pulse compression along the last axis.

    With ``extract=True`` returns the aligned segment of the same length as
    ``echo`` (full convolution sampled from index ``len(pulse)-1``, the
    reference's ``offset : offset+len-1`` extraction).  With ``extract=False``
    returns the full ``N+M-1`` linear convolution (``fun_pulse_compression.m``
    return value).
    """
    m = echo.shape[-1]
    n = int(np.shape(pulse)[-1])
    conv_len = n + m - 1
    nfft = _fft_len(conv_len)
    cdtype = _complex_dtype_like(echo)

    h = jnp.conj(jnp.asarray(pulse, dtype=cdtype)[..., ::-1])
    spec = jnp.fft.fft(echo.astype(cdtype), nfft, axis=-1) * jnp.fft.fft(h, nfft, axis=-1)
    full = jnp.fft.ifft(spec, nfft, axis=-1)[..., :conv_len]
    if not extract:
        return full
    return full[..., n - 1 : n - 1 + m]


def fir_compress(
    echo: jnp.ndarray,
    taps: Sequence[float] = NARROW_PULSE_FIR_TAPS,
    normalize: bool = True,
    post_scale: float = 1.0 / 1.2,
    roll_group_delay: bool = True,
) -> jnp.ndarray:
    """Causal FIR filtering of the narrow-pulse segment along the last axis.

    Matches MATLAB ``filter(b, 1, x)`` followed by
    ``circshift(y, -round(mean(grpdelay(b))))`` (a linear-phase FIR of length
    L has group delay exactly (L-1)/2).  The G0 chain uses the raw taps with
    neither normalization nor the delay roll
    (``DMX_SignalProcessing_main_xzr.m:146,343-344``); the G1/G2 chain
    normalizes, scales by 1/1.2 and rolls (``fun_lss_pulse_compression.m:31-51``).
    """
    b = np.asarray(taps, dtype=np.float64)
    if normalize:
        b = b / b.max()
    m = echo.shape[-1]
    ntaps = b.shape[0]
    nfft = _fft_len(m + ntaps - 1)
    cdtype = _complex_dtype_like(echo)

    spec = jnp.fft.fft(echo.astype(cdtype), nfft, axis=-1) * jnp.fft.fft(
        jnp.asarray(b, dtype=cdtype), nfft
    )
    causal = jnp.fft.ifft(spec, nfft, axis=-1)[..., :m]
    if roll_group_delay:
        # MATLAB round(mean(grpdelay(b))) is half-away-from-zero: a
        # linear-phase FIR of even length L has group delay (L-1)/2 = x.5,
        # which MATLAB rounds UP — floor division would be one sample short
        from radar_signal_process_tpu.config import matlab_round

        causal = jnp.roll(causal, -matlab_round((ntaps - 1) / 2), axis=-1)
    return causal * post_scale


def segmented_pulse_compression(
    echo: jnp.ndarray,
    profile: RadarProfile,
    pulses: Tuple[np.ndarray, ...],
    fir_taps: Sequence[float] = NARROW_PULSE_FIR_TAPS,
) -> jnp.ndarray:
    """Segmented multi-pulse compression (``fun_lss_pulse_compression.m``).

    Splits the fast-time axis into the profile's pulse segments, compresses
    the narrow segment with the FIR path and each chirped segment with the
    matched filter, and re-concatenates.  Fully batched: ``echo`` may carry
    any leading batch dimensions (pulses, beams, slices, frames).
    """
    parts = []
    for i, (start, npts) in enumerate(zip(profile.segment_starts, profile.segment_points)):
        seg = echo[..., start : start + npts]
        if profile.chirp_signs[i] == 0:
            parts.append(fir_compress(seg, fir_taps))
        else:
            parts.append(matched_filter_compress(seg, pulses[i]))
    used = sum(profile.segment_points)
    if used < echo.shape[-1]:
        parts.append(jnp.zeros_like(echo[..., used:]))
    return jnp.concatenate(parts, axis=-1)


def range_concatenate(
    pc: jnp.ndarray,
    spec: Tuple[Tuple[int, int, int], ...],
) -> jnp.ndarray:
    """Remove overlapping post-compression samples and re-concatenate segments.

    ``spec`` entries are ``(dst_start, dst_stop, src_start)`` half-open
    0-based ranges; see ``config.G1_RANGE_CONCAT``
    (reference: ``fun_lss_range_concate.m:4-8``, 1031 -> 868 columns).
    """
    parts = []
    for dst_start, dst_stop, src_start in spec:
        n = dst_stop - dst_start
        parts.append(pc[..., src_start : src_start + n])
    return jnp.concatenate(parts, axis=-1)
