"""Sub-bin motion-parameter measurement (range / velocity / monopulse angle).

Replicates ``CFAR_WangCai/motionParaMeasure.m``: for every CFAR hit, a
``2*extra_dots+1``-cell neighborhood is spline-upsampled (x8 in range, x4 in
velocity), the interpolated peak gives the sub-bin position, and the monopulse
sum/difference ratio gives the elevation angle
(``motionParaMeasure.m:22-82``).

Design notes
------------
* MATLAB ``interp1(..., 'spline')`` is a *not-a-knot* cubic spline.  For a
  fixed support size K and upsample factor u on uniform knots, both the spline
  solve and the evaluation are linear in the sample values, so the whole
  interpolation collapses to one constant ``(Q, K)`` matrix built host-side
  (``spline_eval_matrix``).  Per-detection interpolation on device is then a
  single small matmul — no iterative solves, no dynamic shapes.  The
  matmuls run at ``HIGHEST`` precision: on a GPU a float32 product may
  otherwise run in TF32, and the sub-bin estimates read the spline's peak.
* Detections are irregular; we densify them into a fixed-capacity padded list
  (``extract_detections``) ordered by amplitude, and ``vmap`` the
  per-detection measurement.  Everything stays on device and jit-compatible.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------- spline
@functools.lru_cache(maxsize=None)
def _spline_matrices(n_knots: int) -> tuple:
    """Constant matrices for the not-a-knot cubic spline on uniform knots.

    Returns ``C`` with second-derivatives ``M = C @ y`` for knot values ``y``.
    """
    k = n_knots
    a = np.zeros((k, k))
    rhs_t = np.zeros((k, k))
    # not-a-knot end conditions: third-derivative continuity at the 2nd and
    # second-to-last knots -> M0 - 2 M1 + M2 = 0 (and mirrored).
    a[0, 0:3] = (1.0, -2.0, 1.0)
    a[-1, -3:] = (1.0, -2.0, 1.0)
    for i in range(1, k - 1):
        a[i, i - 1 : i + 2] = (1.0, 4.0, 1.0)
        rhs_t[i, i - 1 : i + 2] = (6.0, -12.0, 6.0)
    c = np.linalg.solve(a, rhs_t)
    return (c,)


@functools.lru_cache(maxsize=None)
def spline_eval_matrix(n_knots: int, upsample: int) -> np.ndarray:
    """Constant (Q, K) matrix evaluating the not-a-knot spline of K uniform
    knots at Q = (K-1)*upsample + 1 uniformly-spaced query points.

    ``values @ P.T`` reproduces MATLAB
    ``interp1(0:K-1, values, 0:1/upsample:K-1, 'spline')``.
    """
    (c,) = _spline_matrices(n_knots)
    k = n_knots
    q = (k - 1) * upsample + 1
    p = np.zeros((q, k))
    for qi in range(q):
        t = qi / upsample
        j = min(int(np.floor(t)), k - 2)  # segment index
        s = t - j
        # cubic segment in terms of (y_j, y_{j+1}, M_j, M_{j+1}), h = 1:
        # S = M_j (1-s)^3/6 + M_{j+1} s^3/6 + (y_j - M_j/6)(1-s) + (y_{j+1} - M_{j+1}/6) s
        w_y = np.zeros(k)
        w_m = np.zeros(k)
        w_y[j] += 1.0 - s
        w_y[j + 1] += s
        w_m[j] += (1.0 - s) ** 3 / 6.0 - (1.0 - s) / 6.0
        w_m[j + 1] += s**3 / 6.0 - s / 6.0
        p[qi, :] = w_y + w_m @ c
    return p


def spline_interp_notaknot(y: jnp.ndarray, upsample: int) -> jnp.ndarray:
    """Not-a-knot cubic-spline upsampling along the last axis (matmul form)."""
    p = spline_eval_matrix(y.shape[-1], upsample)
    return jnp.matmul(y, jnp.asarray(p, dtype=y.dtype).T, precision=_HIGHEST)


# ----------------------------------------------------------------- detections
class DetectionList(NamedTuple):
    """Fixed-capacity padded detection list (amplitude-ordered)."""

    v_idx: jnp.ndarray    # (K,) int32 velocity-cell index into the full RDM
    r_idx: jnp.ndarray    # (K,) int32 range-cell index
    amplitude: jnp.ndarray  # (K,) RDM amplitude at the hit
    valid: jnp.ndarray    # (K,) bool


def extract_detections(
    flags: jnp.ndarray, rdm: jnp.ndarray, max_detections: int = 64
) -> DetectionList:
    """Densify a CFAR flag matrix into a fixed-capacity detection list.

    Keeps the ``max_detections`` strongest hits (the reference iterates over
    all hits; real frames produce far fewer than the default capacity).
    ``flags``/``rdm``: (n_velocity, n_range).
    """
    nv, nr = flags.shape[-2], flags.shape[-1]
    neg = jnp.asarray(-1.0, dtype=rdm.dtype)
    scores = jnp.where(flags, rdm, neg).reshape(*flags.shape[:-2], nv * nr)
    k = min(max_detections, nv * nr)
    top_vals, top_idx = jax.lax.top_k(scores, k)
    valid = top_vals > 0
    return DetectionList(
        v_idx=(top_idx // nr).astype(jnp.int32),
        r_idx=(top_idx % nr).astype(jnp.int32),
        amplitude=top_vals,
        valid=valid,
    )


class Measurements(NamedTuple):
    range_m: jnp.ndarray      # (K,)
    velocity_ms: jnp.ndarray  # (K,)
    elevation_deg: jnp.ndarray  # (K,)
    valid: jnp.ndarray        # (K,) bool
    # optional K12 output: Doppler spectral width per detection, in velocity
    # bins (``ampConstrWidthEst.m``); None unless requested
    spectral_width: jnp.ndarray | None = None


def motion_parameters(
    rdm_sum: jnp.ndarray,
    rdm_diff: jnp.ndarray,
    detections: DetectionList,
    r_scale: np.ndarray | jnp.ndarray,
    delta_r: float,
    v_scale: np.ndarray | jnp.ndarray,
    delta_v: float,
    k_value: jnp.ndarray | float,
    beam_pos: int | jnp.ndarray,
    beam_angle_step: float,
    n_clutter: int,
    extra_dots: int = 2,
    r_interp: int = 8,
    v_interp: int = 4,
    ele_angle_comp: float = 0.0,
    ele_angle_sys_err: float = 0.0,
    spectral_width_db: float | None = None,
    spectral_width_shifted: bool = True,
    spectral_width_interp: int = 1,
) -> Measurements:
    """Per-detection sub-bin range/velocity/elevation estimation.

    ``rdm_sum``/``rdm_diff``: (n_velocity, n_range) magnitude sum/difference
    RDMs.  ``k_value`` is the monopulse slope already selected for
    (freq index, beam position) — ``kValues(freInd+1, beamPosNum+1)``.
    Semantics follow ``motionParaMeasure.m:22-82``; window edge corrections
    clamp the support to a contiguous in-bounds block, exactly as the
    reference's index-rebuild does.

    ``spectral_width_db`` (optional) additionally measures each detection's
    Doppler spectral width from its velocity column with the K12 rule
    (``ampConstrWidthEst.m:6-41``); ``spectral_width_shifted=False`` marks
    unshifted (G0-layout) spectra so the column is fftshift'ed first, and
    ``spectral_width_interp > 1`` enables the reference's spline-upsampled
    sub-bin width mode (``interpFlag``/``interpTimes``).
    """
    nv, nr = rdm_sum.shape
    w = 2 * extra_dots + 1
    p_r = jnp.asarray(spline_eval_matrix(w, r_interp), dtype=rdm_sum.dtype)
    p_v = jnp.asarray(spline_eval_matrix(w, v_interp), dtype=rdm_sum.dtype)
    r_scale = jnp.asarray(r_scale, dtype=rdm_sum.dtype)
    v_scale = jnp.asarray(v_scale, dtype=rdm_sum.dtype)

    def one(v, r):
        # ---- range estimate (motionParaMeasure.m:22-46) ----
        r_start = jnp.clip(r - extra_dots, 0, nr - w)
        row = jax.lax.dynamic_slice(rdm_sum, (v, r_start), (1, w))[0]
        fine = jnp.matmul(row, p_r.T, precision=_HIGHEST)
        i1 = jnp.argmax(fine)
        r_cell_max = r_start.astype(rdm_sum.dtype) + i1.astype(rdm_sum.dtype) / r_interp
        r_est = r_scale[r] + (r_cell_max - r.astype(rdm_sum.dtype)) * delta_r

        # ---- velocity estimate (motionParaMeasure.m:49-73) ----
        v_lo = n_clutter + 1
        v_hi = nv - n_clutter - 1 - (w - 1)
        v_start = jnp.clip(v - extra_dots, v_lo, v_hi)
        col = jax.lax.dynamic_slice(rdm_sum, (v_start, r), (w, 1))[:, 0]
        fine_v = jnp.matmul(col, p_v.T, precision=_HIGHEST)
        i2 = jnp.argmax(fine_v)
        v_cell_max = v_start.astype(rdm_sum.dtype) + i2.astype(rdm_sum.dtype) / v_interp
        v_int = jnp.floor(v_cell_max).astype(jnp.int32)
        v_frac = v_cell_max - v_int.astype(rdm_sum.dtype)
        v_est = v_scale[v_int] - v_frac * delta_v

        # ---- monopulse elevation (motionParaMeasure.m:75-82) ----
        amp_ratio = rdm_diff[v, r] / rdm_sum[v, r]
        ele = (
            beam_pos * beam_angle_step
            + 2.5
            - amp_ratio * k_value
            + ele_angle_comp
            + ele_angle_sys_err
        )
        return r_est, v_est, ele

    r_est, v_est, ele = jax.vmap(one)(detections.v_idx, detections.r_idx)
    width = None
    if spectral_width_db is not None:
        from radar_signal_process_tpu.ops.spectrum import (
            detection_spectral_widths,
        )

        width = detection_spectral_widths(
            rdm_sum, detections.r_idx, spectral_width_db,
            shifted_input=spectral_width_shifted,
            interp=spectral_width_interp > 1,
            interp_times=max(spectral_width_interp, 1),
        )
    return Measurements(
        range_m=r_est, velocity_ms=v_est, elevation_deg=ele,
        valid=detections.valid, spectral_width=width,
    )
