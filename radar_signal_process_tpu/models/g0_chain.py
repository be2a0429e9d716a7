"""G0 end-to-end chain: the fully-vectorized serve-one-frame pipeline.

Replicates ``CFAR_WangCai/DMX_SignalProcessing_main_xzr.m`` (the only
reference driver with no inner loops, SURVEY.md §3.4): per frame,

* split each beam into short / long pulse segments (:330-335),
* FIR-filter the short segment with the raw 35-tap coefficients (:343-344),
* matched-filter the long segment in the frequency domain with a batched
  512-point FFT, peak-at-leading-edge convention
  ``matchF2 = conj(fft(win .* matchWaveform, 512))`` (:200-202, :346-353),
* slow-time Hamming-windowed 2048-point MTD FFT (:413-418),
* monopulse sum (|L|+|R|) and difference (|R|-|L|) beams (:420-426),
* zero the low-velocity clutter rows of the *unshifted* spectrum (:462-465),
* cascaded 2-D CFAR per segment (:468-472),
* sub-bin range/velocity + monopulse elevation measurement (:489-516).

The whole per-frame chain is one jitted function; both beams and both pulse
segments are processed as batched tensor ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radar_signal_process_tpu.config import (
    G0ChainConfig,
    G0_PROFILE,
    NARROW_PULSE_FIR_TAPS,
    RadarProfile,
)
from radar_signal_process_tpu.ops.cfar import cascaded_cfar2d
from radar_signal_process_tpu.ops.measure import (
    DetectionList,
    Measurements,
    extract_detections,
    motion_parameters,
)
from radar_signal_process_tpu.ops.mtd import zero_velocity_notch_unshifted
from radar_signal_process_tpu.ops.pulse_compression import fir_compress
from radar_signal_process_tpu.ops.tables import angle_k_values, freq_value
from radar_signal_process_tpu.ops.windows import make_window


class G0FrameParams(NamedTuple):
    """Per-frame frequency/beam-dependent quantities (traced).

    The reference derives these inside its frame loop from the frame's own
    ``freInd`` / ``beamPosNum`` (``DMX_SignalProcessing_main_xzr.m:310-315``
    for fc/lambda and ``:506-516`` selecting the K value per frame), so a
    frequency-hopping capture gets per-frame-correct velocity scales and
    monopulse slopes.  Passing them as traced arrays lets ONE compiled
    executable serve every frequency point.
    """

    v_scale: object     # (mtd_fft,) velocity scale, sign-inverted (:326-327)
    delta_v: object     # scalar [m/s per Doppler bin]
    k_value: object     # scalar monopulse slope K(freq, beam)
    beam_pos: object    # scalar beam position number


class G0FrameResult(NamedTuple):
    rdm_sum_short: jnp.ndarray    # (mtd_fft, point_short)
    rdm_sum_long: jnp.ndarray     # (mtd_fft, pc_fft)
    rdm_diff_short: jnp.ndarray
    rdm_diff_long: jnp.ndarray
    flags_short: jnp.ndarray
    flags_long: jnp.ndarray
    vflags_short: jnp.ndarray
    vflags_long: jnp.ndarray
    detections_short: DetectionList
    detections_long: DetectionList
    measurements_short: Measurements
    measurements_long: Measurements


class G0Chain:
    """Compiled G0 end-to-end processor.

    ``freq_index``/``beam_pos`` set the *default* frequency point and beam
    position; :meth:`process_frame` accepts per-frame overrides (parsed from
    each frame's own header) with the frequency/beam-dependent scalars
    traced, so frequency hopping reuses one compiled executable.
    """

    def __init__(
        self,
        profile: RadarProfile = G0_PROFILE,
        chain: G0ChainConfig = G0ChainConfig(),
        freq_index: int = 5,
        beam_pos: int = 0,
        match_waveform: np.ndarray | None = None,
        power_norm: bool = True,
        max_detections: int = 32,
        use_split: bool | None = None,
        spectral_width_db: float | None = None,
        spectral_width_interp: int = 1,
    ):
        self.profile = profile
        self.chain = chain
        self.freq_index = freq_index
        self.beam_pos = beam_pos
        self.max_detections = max_detections
        # optional K12 per-detection Doppler width (ampConstrWidthEst.m);
        # G0 spectra are unshifted, so the width rule fftshifts the column
        self.spectral_width_db = spectral_width_db
        self.spectral_width_interp = spectral_width_interp

        ts = profile.ts
        self.fc = freq_value(freq_index)
        self.wavelength = 299792458.0 / self.fc  # lamda = c/fc (:315)

        # ---- matched filter for the long pulse (:152-205) ----
        tau2 = profile.pulse_widths[1]
        if match_waveform is None:
            # LFM reference: exp(j*pi*K2*t^2), K2 = B/tau2 (:161-162)
            n2 = int(round(tau2 / ts))
            t2 = np.arange(n2) * ts - tau2 / 2.0
            k2 = profile.bandwidth / tau2
            match_waveform = np.exp(1j * np.pi * k2 * t2**2)
        if power_norm:
            match_waveform = match_waveform / np.linalg.norm(match_waveform)  # (:166)
        win = make_window(chain.pc_window, len(match_waveform), chain.pc_window_beta)
        self._match_spec = np.conj(
            np.fft.fft(match_waveform * win, chain.pc_fft_length)
        )  # peak at pulse leading edge (:202)

        # ---- MTD window (:208-229; betaMTD=4.5 for the kaiser option) ----
        self._mtd_window = make_window(
            chain.mtd_window, profile.prt_per_frame, chain.mtd_window_beta
        )

        # ---- clutter / scales (:317-327, :462) ----
        delta_doppler = profile.prf / chain.mtd_fft_length
        self._delta_doppler = delta_doppler
        self._f_scale = np.fft.fftshift(
            np.arange(-chain.mtd_fft_length // 2, chain.mtd_fft_length // 2)
            * delta_doppler
        )
        self._params_cache: dict = {}
        params, n_clutter = self.frame_params(freq_index, beam_pos)
        self.v_scale = np.asarray(params.v_scale)
        self.delta_v = float(params.delta_v)
        self.n_clutter = n_clutter
        point_short = profile.segment_points[0]
        self.r_scale_short = (
            np.arange(point_short) * profile.delta_r
            + chain.r_sys_err_short
            - chain.r_measure_err_short
        )
        self.r_scale_long = (
            np.arange(chain.pc_fft_length) * profile.delta_r
            + chain.r_sys_err_long
            - chain.r_measure_err_long
        )
        self.k_value = float(params.k_value)

        # XLA CPU re-computes fused producers into every consumer within one
        # executable (see docs/design.md), so on CPU the chain runs as
        # Python-composed stage executables with the split CFAR cascade —
        # measured ~2.2x the one-executable form, bit-identical results.
        # The GPU runs the one-executable form: 2.39 ms per frame against
        # 3.20 ms split on an H100 at 700 W (chip_smoke.py times both).
        if use_split is None:
            use_split = jax.default_backend() == "cpu"
        self._use_split = use_split

        # n_clutter is static (it sets notch/CFAR crop geometry); the
        # frequency/beam-dependent scalars are traced via G0FrameParams, so
        # one executable serves every frequency point with the same
        # n_clutter (the 11-point table yields at most two distinct values)
        self._process = jax.jit(self._process_impl, static_argnums=(3,))
        self._front = jax.jit(self._front_impl, static_argnums=(2,))
        self._finish = jax.jit(self._finish_impl, static_argnums=(7,))
        self._cfar_split_cache: dict = {}

    def _cfar_split_for(self, n_clutter: int):
        # the shared two-executable split cascade (models.detect); the G0
        # front applies its own unshifted clutter zeroing, so no re-notch
        from radar_signal_process_tpu.models.detect import make_split_detector

        det = self._cfar_split_cache.get(n_clutter)
        if det is None:
            det = make_split_detector(
                self.profile, n_clutter, cfg=self.profile.cfar,
                renotch_divisor=None,
            )
            self._cfar_split_cache[n_clutter] = det
        return det

    def frame_params(
        self, freq_index: int, beam_pos: int
    ) -> "tuple[G0FrameParams, int]":
        """Frequency/beam-dependent scalars for one frame.

        Host-side float64 computation identical to the reference's in-loop
        derivation (``DMX_SignalProcessing_main_xzr.m:310-327,506-516``):
        fc from the 11-point frequency table, lambda = c/fc, the
        sign-inverted velocity scale, delta-v, the clutter-row count and the
        monopulse K value for (freq, beam).
        """
        key = (int(freq_index), int(beam_pos))
        hit = self._params_cache.get(key)
        if hit is not None:
            return hit
        chain = self.chain
        n_freq, n_beam = angle_k_values(chain.sys_num).shape
        if not (0 <= key[0] < n_freq and 0 <= key[1] < n_beam):
            # agile mode feeds capture-parsed header fields here; a corrupt
            # header must fail loud, not wrap into the wrong table row
            # (MATLAB's freValueGen switch would error the same way)
            raise ValueError(
                f"freq_index/beam_pos ({key[0]}, {key[1]}) outside the "
                f"calibration tables ({n_freq} x {n_beam}); corrupt frame "
                "header? pin --freq-index/--beam-pos to override"
            )
        fc = freq_value(key[0])
        wavelength = 299792458.0 / fc                      # lamda = c/fc (:315)
        delta_v = wavelength * self._delta_doppler / 2.0
        n_clutter = int(math.floor(chain.mtd_clutter_v / delta_v))
        v_scale = -wavelength * self._f_scale / 2.0        # (:326-327)
        k_value = float(angle_k_values(chain.sys_num)[key[0], key[1]])
        # Python scalars stay weakly typed under trace, matching the dtype
        # promotion the previous baked-constant form had on every backend.
        params = G0FrameParams(
            v_scale=v_scale,
            delta_v=float(delta_v),
            k_value=float(k_value),
            beam_pos=int(key[1]),
        )
        self._params_cache[key] = (params, n_clutter)
        return params, n_clutter

    def compensate_angle(self, angle_code: np.ndarray) -> np.ndarray:
        """North-angle compensation: rem(angle + northAngle + angleE1, 360) (:310)."""
        return np.remainder(
            angle_code + self.chain.north_angle + self.chain.angle_e1, 360.0
        )

    # ------------------------------------------------------------------ core
    def _pc(self, left: jnp.ndarray, right: jnp.ndarray):
        prof, chain = self.profile, self.chain
        point_short = prof.segment_points[0]
        beams = jnp.stack([left, right])  # (2, prt, point_prt)
        short = beams[..., :point_short]
        long = beams[..., point_short:]

        # short: raw-tap causal FIR, no normalization / delay roll (:146,:343)
        short_mf = fir_compress(
            short, NARROW_PULSE_FIR_TAPS, normalize=False, post_scale=1.0,
            roll_group_delay=False,
        )
        # long: batched frequency-domain matched filter (:348-353)
        spec = jnp.fft.fft(long, chain.pc_fft_length, axis=-1)
        match = jnp.asarray(self._match_spec, dtype=spec.dtype)
        long_mf = jnp.fft.ifft(spec * match, axis=-1)
        return short_mf, long_mf

    def _mtd(self, mf: jnp.ndarray) -> jnp.ndarray:
        # slow-time windowed FFT, unshifted (:413-418)
        w = jnp.asarray(self._mtd_window, dtype=jnp.real(mf).dtype)
        return jnp.fft.fft(mf * w[None, :, None], self.chain.mtd_fft_length, axis=-2)

    def _mtd_mag(self, mf: jnp.ndarray) -> jnp.ndarray:
        """|MTD FFT| per beam."""
        return jnp.abs(self._mtd(mf))

    def _front_impl(self, left: jnp.ndarray, right: jnp.ndarray, n_clutter: int):
        """PC -> |MTD| -> monopulse sum/diff -> clutter notch."""
        short_mf, long_mf = self._pc(left, right)
        abs_short = self._mtd_mag(short_mf)   # (2, mtd_fft, point_short)
        abs_long = self._mtd_mag(long_mf)     # (2, mtd_fft, pc_fft)
        sum_short = abs_short[0] + abs_short[1]     # |L| + |R| (:421-422)
        sum_long = abs_long[0] + abs_long[1]
        diff_short = abs_short[1] - abs_short[0]    # |R| - |L| (:425-426)
        diff_long = abs_long[1] - abs_long[0]

        sum_short = zero_velocity_notch_unshifted(sum_short, n_clutter)
        sum_long = zero_velocity_notch_unshifted(sum_long, n_clutter)
        return sum_short, sum_long, diff_short, diff_long

    def _process_impl(
        self,
        left: jnp.ndarray,
        right: jnp.ndarray,
        params: G0FrameParams,
        n_clutter: int,
    ) -> G0FrameResult:
        prof = self.profile
        cfar = prof.cfar

        sum_short, sum_long, diff_short, diff_long = self._front_impl(
            left, right, n_clutter
        )

        flags_s, vflags_s = cascaded_cfar2d(sum_short, cfar, n_clutter)
        flags_l, vflags_l = cascaded_cfar2d(sum_long, cfar, n_clutter)

        dets_s, dets_l, meas_s, meas_l = self._finish_impl(
            sum_short, sum_long, diff_short, diff_long, flags_s, flags_l,
            params, n_clutter,
        )
        return G0FrameResult(
            rdm_sum_short=sum_short, rdm_sum_long=sum_long,
            rdm_diff_short=diff_short, rdm_diff_long=diff_long,
            flags_short=flags_s, flags_long=flags_l,
            vflags_short=vflags_s, vflags_long=vflags_l,
            detections_short=dets_s, detections_long=dets_l,
            measurements_short=meas_s, measurements_long=meas_l,
        )

    def _finish_impl(self, sum_short, sum_long, diff_short, diff_long,
                     flags_s, flags_l, params: G0FrameParams, n_clutter: int):
        """CFAR flags -> padded detection lists -> sub-bin measurements."""
        prof = self.profile
        dets_s = extract_detections(flags_s, sum_short, self.max_detections)
        dets_l = extract_detections(flags_l, sum_long, self.max_detections)

        common = dict(
            delta_r=prof.delta_r,
            v_scale=params.v_scale,
            delta_v=params.delta_v,
            k_value=params.k_value,
            beam_pos=params.beam_pos,
            beam_angle_step=self.chain.beam_angle_step,
            n_clutter=n_clutter,
            extra_dots=self.chain.extra_dots,
            r_interp=self.chain.r_interp_times,
            v_interp=self.chain.v_interp_times,
            ele_angle_comp=self.chain.ele_angle_comp,
            ele_angle_sys_err=self.chain.ele_angle_sys_err,
            spectral_width_db=self.spectral_width_db,
            spectral_width_shifted=False,
            spectral_width_interp=self.spectral_width_interp,
        )
        meas_s = motion_parameters(
            sum_short, diff_short, dets_s, r_scale=self.r_scale_short, **common
        )
        meas_l = motion_parameters(
            sum_long, diff_long, dets_l, r_scale=self.r_scale_long, **common
        )
        return dets_s, dets_l, meas_s, meas_l

    def process_frame(
        self,
        left,
        right,
        freq_index: int | None = None,
        beam_pos: int | None = None,
    ) -> G0FrameResult:
        """Process one frame: ``left``/``right`` (prt_per_frame, point_prt).

        ``freq_index``/``beam_pos`` default to the values the chain was
        constructed with; pass the frame's own parsed ``freInd`` /
        ``beamPosNum`` for per-frame frequency/beam agility (the reference
        derives lambda, the velocity scale and the monopulse K value inside
        its frame loop, ``DMX_SignalProcessing_main_xzr.m:310-315,506-516``).
        """
        params, n_clutter = self.frame_params(
            self.freq_index if freq_index is None else freq_index,
            self.beam_pos if beam_pos is None else beam_pos,
        )
        if not self._use_split:
            return self._process(
                jnp.asarray(left), jnp.asarray(right), params, n_clutter
            )
        ss, sl, ds, dl = self._front(
            jnp.asarray(left), jnp.asarray(right), n_clutter
        )
        cfar_split = self._cfar_split_for(n_clutter)
        flags_s, vflags_s = cfar_split(ss)
        flags_l, vflags_l = cfar_split(sl)
        dets_s, dets_l, meas_s, meas_l = self._finish(
            ss, sl, ds, dl, flags_s, flags_l, params, n_clutter
        )
        return G0FrameResult(
            rdm_sum_short=ss, rdm_sum_long=sl,
            rdm_diff_short=ds, rdm_diff_long=dl,
            flags_short=flags_s, flags_long=flags_l,
            vflags_short=vflags_s, vflags_long=vflags_l,
            detections_short=dets_s, detections_long=dets_l,
            measurements_short=meas_s, measurements_long=meas_l,
        )
