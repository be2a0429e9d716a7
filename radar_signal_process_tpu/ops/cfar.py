"""Cell-averaging CFAR detection: 1-D CA-CFAR and the cascaded 2-D detector.

Replicated reference semantics (file:line):

* 1-D CA-CFAR per cell: left/right reference-window means with guard cells,
  all-or-nothing window validity with fallback to the opposite side at the
  edges, greatest-of (method 0) / smallest-of (method 1) selection, threshold
  ``T * ref``, flag = ``data >= threshold`` —
  ``CFAR_WangCai/Function_CFAR1D_sub.m:17-68``;
* cascaded 2-D CFAR: crop the clutter-notched Doppler rows, velocity-dim CFAR,
  then a range-dim confirmation pass run only at velocity hits over the
  ``+-1``-cell neighborhood, keeping the strongest confirmed range cell per
  hit — ``CFAR_WangCai/executeCFAR.m:21-92`` with
  ``Function_CFAR1D_sub_fixCells.m`` for the selected-cell pass;
* per-pulse-segment CFAR over the concatenated RDM —
  ``CFAR_WangCai/main_cfar.m:142-161``.

Design notes
------------
The reference's range-dim pass is data-dependent (it only runs at velocity-hit
positions) — irregular work that maps poorly onto a vector accelerator.  We
use the dense masked formulation planned in SURVEY.md §7.3: compute the
range-dim CFAR flag *everywhere* with the same vectorized sliding-mean
machinery, then intersect with the velocity hits and resolve the "strongest
confirmed neighbor" rule with a static 3-way shifted argmax.  Identical
outputs, fully regular compute.

Sliding reference sums are built from ``2*ref_cells`` static rolls (exact
arithmetic, no cumsum error accumulation; XLA fuses the adds into one
elementwise chain).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from radar_signal_process_tpu.config import CFARConfig


def cfar1d_ref_level(
    data: jnp.ndarray,
    ref_cells: int,
    guard_cells: int,
    method: int = 0,
    axis: int = -1,
) -> jnp.ndarray:
    """Selected reference level (GO/SO of the left/right window means).

    ``data`` is real magnitude; the estimate is formed independently for every
    cell along ``axis`` with any leading batch dimensions.
    Assumes ``data.shape[axis] > ref_cells + guard_cells`` (as the reference
    does implicitly — with both windows out of range MATLAB would error).

    All shifts run along the native ``axis`` — a ``moveaxis`` round-trip
    materializes two full transposes of the (large) RDM on CPU backends
    (measured 3.8x slower for the velocity-dim pass).
    """
    axis = axis % data.ndim
    n = data.shape[axis]
    r, g = ref_cells, guard_cells

    # one shared r-term running sum feeds both windows:
    # acc[y] = sum_{j=0..r-1} data[y-j]; left = acc shifted by g+1,
    # right = acc shifted by -(g+r) — (r-1)+2 rolls instead of 2r.
    acc = data
    for k in range(1, r):
        acc = acc + jnp.roll(data, k, axis=axis)
    left_mean = jnp.roll(acc, g + 1, axis=axis) / r
    right_mean = jnp.roll(acc, -(g + r), axis=axis) / r

    shape = [1] * data.ndim
    shape[axis] = n
    idx = np.arange(n).reshape(shape)
    left_valid = jnp.asarray(idx - (g + r) >= 0)
    right_valid = jnp.asarray(idx + (g + r) <= n - 1)
    left_used = jnp.where(left_valid, left_mean, right_mean)
    right_used = jnp.where(right_valid, right_mean, left_mean)

    if method == 0:
        return jnp.maximum(left_used, right_used)
    return jnp.minimum(left_used, right_used)


def cfar1d(
    data: jnp.ndarray,
    ref_cells: int,
    guard_cells: int,
    threshold: float,
    method: int = 0,
    axis: int = -1,
) -> jnp.ndarray:
    """1-D CA-CFAR flag matrix (bool), ``Function_CFAR1D_sub`` semantics."""
    ref = cfar1d_ref_level(data, ref_cells, guard_cells, method, axis)
    return data >= ref * threshold


def cascaded_cfar2d(
    rdm: jnp.ndarray,
    cfg: CFARConfig,
    n_clutter: int,
    cfg_range: CFARConfig | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cascaded velocity-then-range 2-D CFAR (``executeCFAR.m``).

    ``rdm``: (..., n_velocity, n_range) magnitude RDM.  ``n_clutter`` is the
    reference's ``MTD_0_num``.  Returns ``(flags, vflags)`` bool arrays of the
    full RDM shape: the cascade result and the velocity-dim-only result.
    ``cfg`` provides the velocity-dim parameters; ``cfg_range`` the range-dim
    parameters (defaults to ``cfg``, as every reference call site passes equal
    values).

    Precondition: amplitudes must be finite (magnitude RDMs always are).  A
    NaN amplitude at a flagged candidate loses every tie-break comparison in
    the branch-free selection, which can drop a finite co-candidate the
    MATLAB loop would keep.
    """
    cfg_r = cfg_range or cfg
    nv = rdm.shape[-2]

    # Crop the clutter-notched Doppler rows: 1-based MTD_0_num+2 .. nv-MTD_0_num
    lo, hi = n_clutter + 1, nv - n_clutter
    used = rdm[..., lo:hi, :]

    # --- velocity-dim CFAR (along axis -2) ---
    vflag_used = cfar1d(
        used, cfg.ref_cells, cfg.guard_cells, cfg.threshold, cfg.method, axis=-2
    )

    vflags = jnp.zeros(rdm.shape, dtype=bool)
    vflags = vflags.at[..., lo:hi, :].set(vflag_used)

    if not cfg.range_detect:
        return vflags, vflags

    # --- dense range-dim CFAR everywhere (SURVEY.md §7.3 masked formulation) ---
    rflag_dense = cfar1d(
        used, cfg_r.ref_cells, cfg_r.guard_cells, cfg_r.threshold, cfg_r.method, axis=-1
    )

    # For each velocity hit at (v, r): candidate range cells r + d for
    # d in [-range_extend_cells .. +range_extend_cells] (in-bounds only —
    # the edge fill of ``_shift_range(flag, d, fill=False)`` IS the
    # in-bounds condition, so no separate validity mask is needed); among
    # candidates whose dense range flag is set, keep the one with the
    # largest amplitude (first on ties, matching MATLAB max()).
    ext = cfg.range_extend_cells
    neg_inf = jnp.asarray(-jnp.inf, dtype=used.dtype)

    if ext == 1:
        # Branch-free form for the reference's +-1-cell neighborhood with
        # flag-gated comparisons: instead of materializing three masked
        # f32 candidate arrays (``where(flag, val, -inf)`` — the dominant
        # memory traffic; measured ~2x the cfar1d passes on CPU), compare
        # the raw shifted amplitudes and fold the flags into the boolean
        # logic.  ``m_a >= m_b`` with masked -inf is equivalent to
        # ``(v_a >= v_b) | ~f_b`` whenever ``f_a`` holds (if ``f_b`` is
        # unset the rhs is -inf, so the comparison is vacuously true; NaN
        # amplitudes compare false either way).  First-maximum priority
        # (-1 beats 0 beats +1 on ties) uses ``>=`` toward earlier
        # offsets.  Results are bit-identical to the loop form below for
        # finite amplitudes (documented precondition: NaN inputs make a
        # NaN candidate lose all comparisons in *both* forms' take-masks,
        # differing only from a hypothetical strict-> loop ordering).
        f_m1 = _shift_range(rflag_dense, -1, fill=False)
        f_0 = rflag_dense
        f_p1 = _shift_range(rflag_dense, 1, fill=False)
        v_m1 = _shift_range(used, -1, fill=0.0)
        v_0 = used
        v_p1 = _shift_range(used, 1, fill=0.0)
        winner = vflag_used & (f_m1 | f_0 | f_p1)
        ge_m1_0 = (v_m1 >= v_0) | ~f_0
        ge_m1_p1 = (v_m1 >= v_p1) | ~f_p1
        ge_0_p1 = (v_0 >= v_p1) | ~f_p1
        take_m1 = f_m1 & ge_m1_0 & ge_m1_p1
        take_0 = ~take_m1 & f_0 & ge_0_p1
        take_p1 = ~take_m1 & ~take_0 & f_p1
        cascade_used = (
            _shift_range(winner & take_m1, 1, fill=False)
            | (winner & take_0)
            | _shift_range(winner & take_p1, -1, fill=False)
        )
        flags = jnp.zeros(rdm.shape, dtype=bool)
        flags = flags.at[..., lo:hi, :].set(cascade_used)
        return flags, vflags

    # General neighborhood: running best-value/best-offset update (strict
    # ``>`` keeps the first maximum), same selection form as the fused
    # Pallas kernel.
    best_val = jnp.full(used.shape, -jnp.inf, dtype=used.dtype)
    best_off = jnp.zeros(used.shape, dtype=jnp.int32)
    for d in range(-ext, ext + 1):
        shifted_flag = _shift_range(rflag_dense, d, fill=False)
        shifted_val = _shift_range(used, d, fill=0.0)
        val = jnp.where(shifted_flag, shifted_val, neg_inf)
        take = val > best_val
        best_val = jnp.where(take, val, best_val)
        best_off = jnp.where(take, jnp.int32(d), best_off)
    winner = vflag_used & (best_val > neg_inf)

    # Scatter the winners back to their confirmed range cell r + best_off.
    cascade_used = jnp.zeros(used.shape, dtype=bool)
    for d in range(-ext, ext + 1):
        sel = winner & (best_off == d)
        # a winner at column r marks column r + d: shift sel right by d
        cascade_used = cascade_used | _shift_range(sel, -d, fill=False)

    flags = jnp.zeros(rdm.shape, dtype=bool)
    flags = flags.at[..., lo:hi, :].set(cascade_used)
    return flags, vflags


def _shift_range(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """Shift along the last axis so out[..., r] = x[..., r+d], edge-filled."""
    if d == 0:
        return x
    fill_arr = jnp.full_like(x[..., :abs(d)], fill)
    if d > 0:
        return jnp.concatenate([x[..., d:], fill_arr], axis=-1)
    return jnp.concatenate([fill_arr, x[..., :d]], axis=-1)


# ---------------------------------------------------------------------------
# Split two-executable CFAR (the fast CPU path)
# ---------------------------------------------------------------------------
#
# XLA CPU duplicates fused producers into every consumer within one
# executable: the reference-level chains feeding both the flag compare and
# the 3-way cascade selection get recomputed per consumer, and
# ``optimization_barrier`` does not stop it (CLAUDE.md).  Splitting the
# cascade at its natural materialization point — the (vflag, rflag) pair —
# into two separately-jitted executables bounds every chain to one pass,
# measured 2.2-2.9x faster than the one-executable form on the session CPU
# while staying bit-identical.  Inside each stage, shifted windows are
# static slices of one zero-padded buffer (``_ref_level_padded``) rather
# than ``jnp.roll`` — slices of a shared operand fuse into a single
# elementwise loop on XLA CPU; roll (slice+concat pairs) does not.
#
# Summation order is the lockstep contract (CLAUDE.md): j = 0..r-1 away
# from the cell, identical to ``cfar1d_ref_level``'s r-term running sum,
# so flags are bit-identical for finite inputs on every cell with at least
# one in-range reference window (guaranteed when n > 2*(ref+guard), the
# fuzz-test floor; out-of-range windows read wrapped values in the roll
# form and zeros here, both discarded by the validity select).


def _ref_level_padded(
    data: jnp.ndarray, ref_cells: int, guard_cells: int, method: int, axis: int
) -> jnp.ndarray:
    """``cfar1d_ref_level`` as static slices of one zero-padded buffer."""
    axis = axis % data.ndim
    n = data.shape[axis]
    r, g = ref_cells, guard_cells
    pad_w = g + r
    pads = [(0, 0)] * data.ndim
    pads[axis] = (pad_w, pad_w)
    padded = jnp.pad(data, pads)

    def shifted(off: int) -> jnp.ndarray:  # out[y] = data[y + off]
        idx = [slice(None)] * data.ndim
        idx[axis] = slice(pad_w + off, pad_w + off + n)
        return padded[tuple(idx)]

    left = shifted(-(g + 1))
    for j in range(1, r):
        left = left + shifted(-(g + 1) - j)
    right = shifted(g + r)
    for j in range(1, r):
        right = right + shifted(g + r - j)
    left_mean = left / r
    right_mean = right / r

    shape = [1] * data.ndim
    shape[axis] = n
    idx = np.arange(n).reshape(shape)
    left_valid = jnp.asarray(idx - (g + r) >= 0)
    right_valid = jnp.asarray(idx + (g + r) <= n - 1)
    left_used = jnp.where(left_valid, left_mean, right_mean)
    right_used = jnp.where(right_valid, right_mean, left_mean)
    if method == 0:
        return jnp.maximum(left_used, right_used)
    return jnp.minimum(left_used, right_used)


def _pad_shift(x: jnp.ndarray, ext: int, axis: int = -1):
    """Padded-buffer shifter: shifted(d) = x shifted so out[y] = x[y+d] on axis."""
    axis = axis % x.ndim
    pads = [(0, 0)] * x.ndim
    pads[axis] = (ext, ext)
    padded = jnp.pad(x, pads)
    n = x.shape[axis]

    def shifted(d: int) -> jnp.ndarray:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(ext + d, ext + d + n)
        return padded[tuple(idx)]

    return shifted


def _split_axes(transposed: bool) -> Tuple[int, int]:
    """(velocity_axis, range_axis) for the split-cascade layout."""
    return (-1, -2) if transposed else (-2, -1)


def _axis_slice(x: jnp.ndarray, start: int, stop: int, axis: int) -> jnp.ndarray:
    idx = [slice(None)] * x.ndim
    idx[axis % x.ndim] = slice(start, stop)
    return x[tuple(idx)]


def segmented_cfar_flags(
    rdm: jnp.ndarray,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    cfg_range: CFARConfig | None = None,
    transposed: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stage A of the split cascade: velocity- and range-dim flag planes.

    Returns ``(vflag, rflag)`` over the clutter-cropped rows and full column
    width.  The velocity-dim CFAR is column-local, so one full-width pass
    equals the per-segment form; the range-dim pass honors segment edges.
    Jit this and :func:`segmented_cfar_select` as SEPARATE executables.

    ``transposed=True`` takes/returns the (..., n_range, n_velocity) layout
    (see ``doppler_process_range_major``): the velocity-dim pass then runs
    along the contiguous axis, ~2x the cascade throughput on CPU.
    """
    cfg_r = cfg_range or cfg
    v_ax, r_ax = _split_axes(transposed)
    lo, hi = n_clutter + 1, rdm.shape[v_ax] - n_clutter
    used = _axis_slice(rdm, lo, hi, v_ax)
    vref = _ref_level_padded(used, cfg.ref_cells, cfg.guard_cells, cfg.method, v_ax)
    vflag = used >= vref * cfg.threshold
    if not cfg.range_detect:
        return vflag, vflag
    rflags = []
    for start, stop in segments:
        seg = _axis_slice(used, start, stop, r_ax)
        rref = _ref_level_padded(
            seg, cfg_r.ref_cells, cfg_r.guard_cells, cfg_r.method, r_ax
        )
        rflags.append(seg >= rref * cfg_r.threshold)
    return vflag, jnp.concatenate(rflags, axis=r_ax)


def segmented_cfar_ref_levels(
    rdm: jnp.ndarray,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    cfg_range: CFARConfig | None = None,
    transposed: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Threshold-independent reference levels ``(vref, rref)``.

    The CA-CFAR reference level (GO/SO of the left/right window means) does
    not depend on the threshold, so a threshold sweep (the reference's
    ``for T=[...]`` loop, ``main_cfar.m:40``) computes these once per RDM and
    re-runs only the compare + cascade per ``T`` —
    see :func:`segmented_cfar_from_ref_levels`.
    """
    cfg_r = cfg_range or cfg
    v_ax, r_ax = _split_axes(transposed)
    lo, hi = n_clutter + 1, rdm.shape[v_ax] - n_clutter
    used = _axis_slice(rdm, lo, hi, v_ax)
    vref = _ref_level_padded(used, cfg.ref_cells, cfg.guard_cells, cfg.method, v_ax)
    rrefs = []
    for start, stop in segments:
        seg = _axis_slice(used, start, stop, r_ax)
        rrefs.append(
            _ref_level_padded(
                seg, cfg_r.ref_cells, cfg_r.guard_cells, cfg_r.method, r_ax
            )
        )
    return vref, jnp.concatenate(rrefs, axis=r_ax)


def segmented_cfar_from_ref_levels(
    rdm: jnp.ndarray,
    vref: jnp.ndarray,
    rref: jnp.ndarray,
    threshold: jnp.ndarray | float,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    threshold_range: jnp.ndarray | float | None = None,
    transposed: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cascade flags from precomputed reference levels at a (traced) threshold.

    ``threshold`` may be a traced scalar, so one compiled executable covers a
    whole sweep.  Bit-identical to :func:`segmented_cfar` with
    ``cfg.threshold == threshold`` for the same RDM.
    """
    t_r = threshold if threshold_range is None else threshold_range
    v_ax, _ = _split_axes(transposed)
    lo, hi = n_clutter + 1, rdm.shape[v_ax] - n_clutter
    used = _axis_slice(rdm, lo, hi, v_ax)
    vflag = used >= vref * threshold
    if not cfg.range_detect:
        rflag = vflag
    else:
        rflag = used >= rref * t_r
    return segmented_cfar_select(
        rdm, vflag, rflag, segments, cfg, n_clutter, transposed=transposed
    )


def segmented_cfar_select(
    rdm: jnp.ndarray,
    vflag: jnp.ndarray,
    rflag: jnp.ndarray,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    transposed: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stage B of the split cascade: per-hit strongest-neighbor resolution.

    Consumes the stage-A flag planes plus the (notched) RDM and emits the
    full-size ``(flags, vflags)`` pair, bit-identical to
    :func:`segmented_cfar` (transposed when ``transposed=True``).
    """
    v_ax, r_ax = _split_axes(transposed)
    nv = rdm.shape[v_ax]
    lo, hi = n_clutter + 1, nv - n_clutter
    used_full = _axis_slice(rdm, lo, hi, v_ax)
    embed_pads = [(0, 0)] * rdm.ndim
    embed_pads[v_ax % rdm.ndim] = (lo, nv - hi)
    if not cfg.range_detect:
        vflags = jnp.pad(vflag, embed_pads)
        return vflags, vflags

    ext = cfg.range_extend_cells
    neg_inf = jnp.asarray(-jnp.inf, dtype=used_full.dtype)
    parts = []
    for start, stop in segments:
        u = _axis_slice(used_full, start, stop, r_ax)
        vf = _axis_slice(vflag, start, stop, r_ax)
        rf = _axis_slice(rflag, start, stop, r_ax)
        shift_f = _pad_shift(rf, ext, r_ax)
        shift_v = _pad_shift(u, ext, r_ax)
        if ext == 1:
            # flag-gated comparison form, as in cascaded_cfar2d's fast path
            f_m1, f_0, f_p1 = shift_f(-1), rf, shift_f(1)
            v_m1, v_0, v_p1 = shift_v(-1), u, shift_v(1)
            winner = vf & (f_m1 | f_0 | f_p1)
            take_m1 = (
                f_m1 & ((v_m1 >= v_0) | ~f_0) & ((v_m1 >= v_p1) | ~f_p1)
            )
            take_0 = ~take_m1 & f_0 & ((v_0 >= v_p1) | ~f_p1)
            take_p1 = ~take_m1 & ~take_0 & f_p1
            shift_w1 = _pad_shift(winner & take_m1, 1, r_ax)
            shift_w2 = _pad_shift(winner & take_p1, 1, r_ax)
            parts.append(shift_w1(1) | (winner & take_0) | shift_w2(-1))
            continue
        best_val = jnp.full(u.shape, -jnp.inf, dtype=u.dtype)
        best_off = jnp.zeros(u.shape, dtype=jnp.int32)
        for d in range(-ext, ext + 1):
            val = jnp.where(shift_f(d), shift_v(d), neg_inf)
            take = val > best_val
            best_val = jnp.where(take, val, best_val)
            best_off = jnp.where(take, jnp.int32(d), best_off)
        winner = vf & (best_val > neg_inf)
        cascade = jnp.zeros(u.shape, dtype=bool)
        shift_c = _pad_shift
        for d in range(-ext, ext + 1):
            sel = winner & (best_off == d)
            cascade = cascade | shift_c(sel, ext, r_ax)(-d)
        parts.append(cascade)

    flags = jnp.pad(jnp.concatenate(parts, axis=r_ax), embed_pads)
    vflags = jnp.pad(vflag, embed_pads)
    return flags, vflags


def segmented_cfar(
    rdm: jnp.ndarray,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pulse-segment cascaded CFAR over the full RDM columns.

    Splits the range axis by ``segments`` (half-open 0-based column ranges, the
    reference's ``[1:82 | 83:318 | 319:868]`` pulse-type split,
    ``main_cfar.m:142-161``), runs the cascade per segment and re-assembles.
    """
    flag_parts, vflag_parts = [], []
    for start, stop in segments:
        f, v = cascaded_cfar2d(rdm[..., start:stop], cfg, n_clutter)
        flag_parts.append(f)
        vflag_parts.append(v)
    return (
        jnp.concatenate(flag_parts, axis=-1),
        jnp.concatenate(vflag_parts, axis=-1),
    )
