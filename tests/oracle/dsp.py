"""Oracle DSP: pulse compression, MTD, clutter suppression (loop style)."""

from __future__ import annotations

import numpy as np


def matched_filter_full(pulse: np.ndarray, echo_row: np.ndarray) -> np.ndarray:
    """fun_pulse_compression.m: conj-reversed impulse response, linear conv."""
    h = np.conj(pulse[::-1])
    n = len(h) + len(echo_row) - 1
    return np.fft.ifft(np.fft.fft(echo_row, n) * np.fft.fft(h, n), n)


def fir_filter_causal(taps: np.ndarray, x: np.ndarray) -> np.ndarray:
    """MATLAB filter(b, 1, x): causal FIR, output truncated to len(x)."""
    return np.convolve(x, taps)[: len(x)]


def segmented_pulse_compression(
    echo: np.ndarray,
    seg_points: tuple,
    pulses: tuple,
    fir_taps: np.ndarray,
) -> np.ndarray:
    """fun_lss_pulse_compression.m: per-PRT segmented compression."""
    n_prt, n_pts = echo.shape
    p1, p2, p3 = seg_points
    b = fir_taps / fir_taps.max()
    delay = int(round((len(b) - 1) / 2.0))
    out = np.zeros((n_prt, n_pts), dtype=np.complex128)
    for i in range(n_prt):
        s1 = fir_filter_causal(b, echo[i, :p1]) / 1.2
        out[i, :p1] = np.roll(s1, -delay)[:p1]
        full2 = matched_filter_full(pulses[1], echo[i, p1 : p1 + p2])
        off2 = len(pulses[1])
        out[i, p1 : p1 + p2] = full2[off2 - 1 : off2 - 1 + p2]
        full3 = matched_filter_full(pulses[2], echo[i, p1 + p2 : p1 + p2 + p3])
        off3 = len(pulses[2])
        out[i, p1 + p2 : p1 + p2 + p3] = full3[off3 - 1 : off3 - 1 + p3]
    return out


def doppler_process(pc: np.ndarray, window: np.ndarray) -> np.ndarray:
    """fun_Process_MTD.m: per-range-bin windowed FFT, fftshift, magnitude."""
    n_pulses, n_range = pc.shape
    out = np.zeros((n_pulses, n_range))
    for j in range(n_range):
        col = pc[:, j] * window
        out[:, j] = np.abs(np.fft.fftshift(np.fft.fft(col, n_pulses)))
    return out


def matlab_round(x: float) -> int:
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


def zero_velocity_notch(rdm: np.ndarray, divisor: int) -> np.ndarray:
    """fun_0v_pressing.m: zero rows round(N/2) +- round(N/divisor) (1-based)."""
    out = rdm.copy()
    n = rdm.shape[0]
    center = matlab_round(n / 2)  # 1-based
    hw = matlab_round(n / divisor)
    out[center - 1 - hw : center + hw, :] = 0.0
    return out


def mti_cancel(echo: np.ndarray, lag: int = 30) -> np.ndarray:
    """fun_Process_MTI.m: x[n+lag] - x[n], trailing rows zero."""
    n, m = echo.shape
    out = np.zeros_like(echo)
    for i in range(n - lag):
        out[i, :] = echo[i + lag, :] - echo[i, :]
    return out


def range_concatenate_g1(pc: np.ndarray) -> np.ndarray:
    """fun_lss_range_concate.m: 1031 -> 868 columns (1-based indices cited)."""
    n_prt = pc.shape[0]
    out = np.zeros((n_prt, 868), dtype=pc.dtype)
    out[:, 0:82] = pc[:, 0:82]
    out[:, 82:318] = pc[:, 89:325]      # MATLAB 83+(82-75) : 325
    out[:, 318:868] = pc[:, 481:1031]   # MATLAB 325+(82+235-160) : 1031
    return out


def g0_sum_rdm(
    left: np.ndarray,
    right: np.ndarray,
    point_short: int,
    fir_taps: np.ndarray,
    match_spec: np.ndarray,
    mtd_fft: int,
    n_clutter: int,
):
    """DMX_SignalProcessing_main_xzr.m:343-465 per PRT and per range bin:
    raw-tap causal FIR on the short segment, circular frequency-domain
    matched filter on the long one, Hamming-windowed unshifted Doppler FFT,
    monopulse sum |L| + |R|, unshifted clutter rows zeroed.

    Returns (sum_short, sum_long)."""
    n_prt = left.shape[0]
    n_pc = len(match_spec)
    window = np.hamming(n_prt)
    sums = []
    for seg in ("short", "long"):
        mags = []
        for beam in (left, right):
            width = point_short if seg == "short" else n_pc
            pc = np.zeros((n_prt, width), dtype=np.complex128)
            for i in range(n_prt):
                if seg == "short":
                    pc[i] = fir_filter_causal(fir_taps, beam[i, :point_short])
                else:
                    spec = np.fft.fft(beam[i, point_short:], n_pc)
                    pc[i] = np.fft.ifft(spec * match_spec)
            rdm = np.zeros((mtd_fft, width))
            for j in range(width):
                rdm[:, j] = np.abs(np.fft.fft(pc[:, j] * window, mtd_fft))
            mags.append(rdm)
        total = mags[0] + mags[1]
        total[: n_clutter + 1, :] = 0.0
        total[mtd_fft - n_clutter :, :] = 0.0
        sums.append(total)
    return sums[0], sums[1]
