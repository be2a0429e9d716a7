"""Range-sharded execution with halo exchange (shard_map + collectives).

The distributed design of SURVEY.md §5.8/§7.1: beams/slices/frames are pure
data parallelism ("dp" axis); the range axis is the sequence-parallel ("sp")
axis.  Pulse compression runs PRT-sharded (fast time local), an ``all_to_all``
re-shards to range so the slow-time Doppler FFT is local per range bin, and
the CFAR range dimension exchanges its reference/guard-cell halos with
neighbor shards via ``ppermute`` — device-to-device collectives only, no host
round-trips.

Halo discipline for the exact cascade: a cell's cascade mark depends on
winners within ±E cells, winners depend on candidate flags within ±E, and a
candidate flag needs ref+guard context — so a halo of ``ref+guard+2E``
columns makes every center-cell result bit-identical to the unsharded
detector, including the global-edge fallback rules (validity is evaluated on
*global* column indices).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radar_signal_process_tpu.config import CFARConfig, RadarProfile
from radar_signal_process_tpu.ops.mtd import doppler_process, zero_velocity_notch
from radar_signal_process_tpu.ops.pulse_compression import segmented_pulse_compression
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu.ops.windows import make_window


def halo_exchange(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Exchange ``halo`` edge columns (last axis) with ring neighbors.

    Returns the local block extended to ``local + 2*halo`` columns.  Edge
    shards receive wrapped data in their outer halo; callers mask those
    positions via global-index validity (the reference's own edge fallback).
    """
    n = lax.axis_size(axis_name)
    if n == 1:
        # single shard: wrap (masked by validity downstream)
        return jnp.concatenate([x[..., -halo:], x, x[..., :halo]], axis=-1)
    to_right = [(i, (i + 1) % n) for i in range(n)]
    to_left = [(i, (i - 1) % n) for i in range(n)]
    from_left = lax.ppermute(x[..., -halo:], axis_name, to_right)
    from_right = lax.ppermute(x[..., :halo], axis_name, to_left)
    return jnp.concatenate([from_left, x, from_right], axis=-1)


def _global_col_index(local_n: int, halo: int, axis_name: str) -> jnp.ndarray:
    """Global column index of each extended-block column."""
    shard = lax.axis_index(axis_name)
    return shard * local_n + jnp.arange(-halo, local_n + halo)


def _segment_bounds(
    gidx: jnp.ndarray,
    segments: Tuple[Tuple[int, int], ...],
    n_global: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-column half-open bounds of the enclosing pulse segment.

    The reference runs CFAR independently per pulse-type segment
    (``main_cfar.m:142-161``), so reference windows and cascade candidates
    must never cross a segment boundary.  Columns outside every segment
    (wrapped global-edge halo) keep the full-width default; their validity
    is settled by the center-column checks downstream.
    """
    lo = jnp.zeros_like(gidx)
    hi = jnp.full_like(gidx, n_global)
    for start, stop in segments:
        inside = (gidx >= start) & (gidx < stop)
        lo = jnp.where(inside, start, lo)
        hi = jnp.where(inside, stop, hi)
    return lo, hi


def _rolled_ref_level(
    ext: jnp.ndarray,
    gidx: jnp.ndarray,
    n_global: int,
    ref_cells: int,
    guard_cells: int,
    method: int,
    bounds: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> jnp.ndarray:
    """GO/SO reference level on an extended block with global-index validity.

    ``bounds`` supplies per-column (lo, hi) segment bounds; window validity
    requires the whole reference window inside the column's own segment —
    identical values to running the unsharded CFAR on that segment alone
    (the running sum consumes the same columns in the same order wherever
    the window is valid, and invalid sides fall back identically).
    """
    r, g = ref_cells, guard_cells
    lo, hi = bounds if bounds is not None else (0, n_global)
    acc = ext
    for k in range(1, r):
        acc = acc + jnp.roll(ext, k, axis=-1)
    left_mean = jnp.roll(acc, g + 1, axis=-1) / r
    right_mean = jnp.roll(acc, -(g + r), axis=-1) / r
    left_valid = gidx - (g + r) >= lo
    right_valid = gidx + (g + r) <= hi - 1
    left_used = jnp.where(left_valid, left_mean, right_mean)
    right_used = jnp.where(right_valid, right_mean, left_mean)
    if method == 0:
        return jnp.maximum(left_used, right_used)
    return jnp.minimum(left_used, right_used)


def sharded_cfar1d_ref_level(
    x_local: jnp.ndarray,
    cfg: CFARConfig,
    axis_name: str,
    n_global: int,
) -> jnp.ndarray:
    """Range-dim CFAR reference level for a range-sharded block (last axis)."""
    local_n = x_local.shape[-1]
    h = cfg.ref_cells + cfg.guard_cells
    ext = halo_exchange(x_local, h, axis_name)
    gidx = _global_col_index(local_n, h, axis_name)
    ref = _rolled_ref_level(
        ext, gidx, n_global, cfg.ref_cells, cfg.guard_cells, cfg.method
    )
    return ref[..., h : h + local_n]


def sharded_cascaded_cfar2d(
    rdm_local: jnp.ndarray,
    cfg: CFARConfig,
    n_clutter: int,
    axis_name: str,
    n_global: int,
    segments: Tuple[Tuple[int, int], ...] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Range-sharded cascaded 2-D CFAR, bit-identical to the unsharded op.

    ``rdm_local``: (..., n_velocity, local_range).  The velocity axis is
    unsharded (local); only the range axis is distributed.  With
    ``segments`` (global half-open column ranges, the reference's
    pulse-type split) the result matches ``ops.cfar.segmented_cfar``:
    reference windows and cascade candidates are confined to each column's
    own segment via per-column validity bounds — no re-slicing, so shard
    boundaries never need to align with segment boundaries.
    """
    nv = rdm_local.shape[-2]
    local_n = rdm_local.shape[-1]
    r, g, e = cfg.ref_cells, cfg.guard_cells, cfg.range_extend_cells
    lo, hi = n_clutter + 1, nv - n_clutter
    used = rdm_local[..., lo:hi, :]

    h = r + g + 2 * e
    ext = halo_exchange(used, h, axis_name)
    gidx = _global_col_index(local_n, h, axis_name)
    bounds = _segment_bounds(gidx, segments, n_global)

    # velocity-dim CFAR: along the local (unsharded) velocity axis, computed
    # for the extended block so neighbor-shard winners are visible.
    ref_v = _rolled_ref_level_velocity(ext, cfg)
    vflag_ext = ext >= ref_v * cfg.threshold

    vflags = jnp.zeros(rdm_local.shape, dtype=bool)
    vflags = vflags.at[..., lo:hi, :].set(vflag_ext[..., h : h + local_n])
    if not cfg.range_detect:
        return vflags, vflags

    # dense range-dim CFAR on the extended block
    ref_r = _rolled_ref_level(ext, gidx, n_global, r, g, cfg.method, bounds)
    rflag_ext = ext >= ref_r * cfg.threshold

    # candidate search around every cell: candidates must stay inside the
    # center cell's segment
    neg_inf = jnp.asarray(-jnp.inf, dtype=ext.dtype)
    seg_lo, seg_hi = bounds
    offsets = list(range(-e, e + 1))
    cand = []
    for d in offsets:
        flag_d = jnp.roll(rflag_ext, -d, axis=-1)
        val_d = jnp.roll(ext, -d, axis=-1)
        inb_d = (gidx + d >= seg_lo) & (gidx + d <= seg_hi - 1)
        cand.append(jnp.where(flag_d & inb_d, val_d, neg_inf))
    stacked = jnp.stack(cand, axis=-1)
    best = jnp.argmax(stacked, axis=-1)
    # A winner must be a REAL global column (and inside a segment when
    # segmented): the global-edge shards' outer halo holds wrapped far-end
    # data, and a phantom winner there would scatter a mark onto the real
    # edge column — guaranteed to fire on clutter-notched all-zero rows,
    # where the self-flagging 0 >= 0 compare makes every halo cell a
    # velocity hit (found by the two-process sp test: 13 phantom flags in
    # column 0).
    center_valid = (gidx >= 0) & (gidx < n_global)
    if segments:
        inside_any = jnp.zeros_like(center_valid)
        for start, stop in segments:
            inside_any = inside_any | ((gidx >= start) & (gidx < stop))
        center_valid = center_valid & inside_any
    winner = vflag_ext & (jnp.max(stacked, axis=-1) > neg_inf) & center_valid

    # receive-side scatter: cell c is marked when the winner at c-d chose d
    mark = jnp.zeros(ext.shape, dtype=bool)
    for i, d in enumerate(offsets):
        sel = winner & (best == i)
        mark = mark | jnp.roll(sel, d, axis=-1)

    flags = jnp.zeros(rdm_local.shape, dtype=bool)
    flags = flags.at[..., lo:hi, :].set(mark[..., h : h + local_n])
    return flags, vflags


def _rolled_ref_level_velocity(ext: jnp.ndarray, cfg: CFARConfig) -> jnp.ndarray:
    """GO/SO reference level along the (unsharded) velocity axis (-2)."""
    r, g = cfg.ref_cells, cfg.guard_cells
    nv = ext.shape[-2]
    acc = ext
    for k in range(1, r):
        acc = acc + jnp.roll(ext, k, axis=-2)
    left_mean = jnp.roll(acc, g + 1, axis=-2) / r
    right_mean = jnp.roll(acc, -(g + r), axis=-2) / r
    idx = jnp.arange(nv).reshape((nv,) + (1,) * 1)
    left_valid = idx - (g + r) >= 0
    right_valid = idx + (g + r) <= nv - 1
    left_used = jnp.where(left_valid, left_mean, right_mean)
    right_used = jnp.where(right_valid, right_mean, left_mean)
    if cfg.method == 0:
        return jnp.maximum(left_used, right_used)
    return jnp.minimum(left_used, right_used)


# --------------------------------------------------------------------- pipeline
def make_sharded_pipeline(
    profile: RadarProfile,
    mesh: Mesh,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    segmented: bool = True,
    renotch_divisor: int | None = None,
):
    """Full sharded processing step: echo -> RDM -> CFAR flags over a 2-D mesh.

    * ``dp`` shards the beam axis (pure data parallelism);
    * ``sp`` shards slow time during pulse compression, then an
      ``all_to_all`` re-shards to range for the Doppler FFT and CFAR
      (halo-exchange collectives for the reference windows).

    Input ``echo``: (n_beams, n_pulses, n_points) complex, n_beams divisible
    by mesh["dp"], n_pulses and n_points divisible by mesh["sp"].
    Returns (rdm, flags, vflags) with the same layout as the unsharded path.

    With ``segmented`` (default) the CFAR honors the profile's pulse-type
    segment split exactly like ``ops.cfar.segmented_cfar``; segments are
    dropped automatically when the profile's table does not tile the actual
    range extent (e.g. truncated dry-run geometries).

    ``renotch_divisor`` applies the detection stage's wide clutter re-notch
    (``main_cfar.m:90-91``, divisor 20) before the CFAR — matching
    ``models.detect.detect_rdm`` semantics — while the returned RDM keeps
    only the MTD-stage notch.
    """
    cfg = cfg or profile.cfar
    pulses = reference_pulses(profile)
    n_sp = mesh.shape[sp_axis]
    segments = profile.cfar_segments if segmented else ()
    if segments and segments[-1][1] != profile.point_prt:
        segments = ()

    def step(echo_local: jnp.ndarray):
        # echo_local: (beams_local, prt_local, n_points)
        n_points = echo_local.shape[-1]
        pc = segmented_pulse_compression(echo_local, profile, pulses)
        # re-shard: slow-time-sharded -> range-sharded
        if n_sp > 1:
            pc = lax.all_to_all(pc, sp_axis, split_axis=2, concat_axis=1, tiled=True)
        n_pulses = pc.shape[-2]
        window = make_window(profile.mtd.window, n_pulses, profile.mtd.window_beta)
        rdm = doppler_process(pc, window, shift=profile.mtd.fftshift)
        if profile.mtd.notch_divisor:
            rdm = zero_velocity_notch(rdm, divisor=profile.mtd.notch_divisor)
        rdm_cfar = rdm
        if renotch_divisor:
            rdm_cfar = zero_velocity_notch(rdm, divisor=renotch_divisor)
        flags, vflags = sharded_cascaded_cfar2d(
            rdm_cfar, cfg, n_clutter, sp_axis, n_points, segments
        )
        return rdm, flags, vflags

    mapped = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=P(dp_axis, sp_axis, None),
        out_specs=(
            P(dp_axis, None, sp_axis),
            P(dp_axis, None, sp_axis),
            P(dp_axis, None, sp_axis),
        ),
        check_vma=False,
    )

    @jax.jit
    def run(echo: jnp.ndarray):
        return mapped(echo)

    return run


def make_sharded_stream(
    profile: RadarProfile,
    mesh: Mesh,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    win_size: int = 4,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    segmented: bool = True,
    renotch_divisor: int | None = None,
    stc_curve_db=None,
    pulses=None,
):
    """Steady-state streaming on a mesh with on-device per-frame PC reuse.

    The frame axis is the reference's streaming axis (``main_cfar.m:82``;
    ``bin_to_mat_xzr.m:57``): in steady state each doubled-CPI window spans
    frames N and N+1, so every frame's compressed rows feed TWO windows.
    The round-3 host-threaded chain exploits that on CPU
    (``models.host_parallel``); this is the mesh form: the compressed,
    range-sharded frame is the jit-carried state, each step compresses ONLY
    the arriving frame (sp-sharded slow time -> ``all_to_all`` -> range),
    concatenates it with the carried previous frame inside the sharded
    executable, and runs the ``win_size`` Doppler/notch/halo-CFAR slices.

    Returns ``(init, step)``:

    * ``init(frame) -> pc_state`` — compress the first frame (the stream
      prologue);
    * ``step(pc_state, frame_next) -> (pc_next, rdms, flags, vflags)`` —
      advance one window; ``rdms``/``flags`` are
      (n_beams, win_size, n_prt, n_points), bit-identical to the host
      streaming chain; feed ``pc_next`` back as the next call's state.

    ``frame``: (n_beams, n_prt, n_points) complex, n_beams % dp == 0,
    n_prt % sp == 0, n_points % sp == 0.  ``stc_curve_db`` / ``pulses``
    mirror the host processors' iSTC and measured-matched-filter hooks
    (iSTC and PC are fast-time-row local, so per-frame application before
    compression matches the window-level semantics bit-for-bit).
    """
    from radar_signal_process_tpu.models.mtd_pipeline import (
        window_slice_starts,
    )

    cfg = cfg or profile.cfar
    pulses = reference_pulses(profile) if pulses is None else pulses
    n_sp = mesh.shape[sp_axis]
    segments = profile.cfar_segments if segmented else ()
    if segments and segments[-1][1] != profile.point_prt:
        segments = ()

    def compress(echo_local: jnp.ndarray) -> jnp.ndarray:
        if profile.mtd.istc and stc_curve_db is not None:
            from radar_signal_process_tpu.ops.mtd import istc_compensate

            echo_local = istc_compensate(echo_local, stc_curve_db)
        pc = segmented_pulse_compression(echo_local, profile, pulses)
        if n_sp > 1:
            # slow-time-sharded -> range-sharded (the PC carry layout)
            pc = lax.all_to_all(pc, sp_axis, split_axis=2, concat_axis=1,
                                tiled=True)
        return pc

    def step_local(pc_prev: jnp.ndarray, echo_local: jnp.ndarray):
        # pc_prev: (beams_local, n_prt, pts_local) range-sharded
        n_points = echo_local.shape[-1]
        pc_next = compress(echo_local)
        n_prt = pc_prev.shape[-2]
        window_pc = jnp.concatenate([pc_prev, pc_next], axis=-2)
        starts = window_slice_starts(n_prt, win_size)
        slices = jnp.stack(
            [window_pc[..., s : s + n_prt, :] for s in starts], axis=-3
        )
        if profile.mtd.mti_lag:
            from radar_signal_process_tpu.ops.mtd import mti_cancel

            slices = mti_cancel(slices, lag=profile.mtd.mti_lag)
        window = make_window(profile.mtd.window, n_prt,
                             profile.mtd.window_beta)
        rdm = doppler_process(slices, window, shift=profile.mtd.fftshift)
        if profile.mtd.notch_divisor:
            rdm = zero_velocity_notch(rdm, divisor=profile.mtd.notch_divisor)
        rdm_cfar = rdm
        if renotch_divisor:
            rdm_cfar = zero_velocity_notch(rdm, divisor=renotch_divisor)
        flags, vflags = sharded_cascaded_cfar2d(
            rdm_cfar, cfg, n_clutter, sp_axis, n_points, segments
        )
        return pc_next, rdm, flags, vflags

    pc_spec = P(dp_axis, None, sp_axis)
    out4 = P(dp_axis, None, None, sp_axis)
    init_mapped = jax.shard_map(
        compress, mesh=mesh, in_specs=P(dp_axis, sp_axis, None),
        out_specs=pc_spec, check_vma=False,
    )
    step_mapped = jax.shard_map(
        step_local, mesh=mesh,
        in_specs=(pc_spec, P(dp_axis, sp_axis, None)),
        out_specs=(pc_spec, out4, out4, out4),
        check_vma=False,
    )

    init = jax.jit(init_mapped)

    @jax.jit
    def step(pc_state: jnp.ndarray, frame_next: jnp.ndarray):
        return step_mapped(pc_state, frame_next)

    return init, step


def make_sharded_e2e(
    profile: RadarProfile,
    mesh: Mesh,
    dbf_coeffs,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    tp_axis: str = "tp",
    segmented: bool = True,
):
    """Raw-channel-cube -> detections over a 3-axis (dp, sp, tp) mesh.

    The full production step from the ingest boundary on:

    * **tp** (tensor parallel) shards the DBF contraction: each device holds
      a channel subset of the raw I/Q and the matching coefficient columns,
      computes its partial ``(..., samples, beams)`` product, and a
      ``psum_scatter`` over the *beam* axis completes the sum while leaving
      each tp member a distinct beam subset — the Megatron contract-dim
      pattern (partial matmul + reduce-scatter), with the beam axis then
      acting as extra data parallelism downstream;
    * **dp** shards the frame batch;
    * **sp** shards slow time through pulse compression, re-shards to range
      via ``all_to_all``, and exchanges CFAR halos via ``ppermute``
      (:func:`sharded_cascaded_cfar2d`).

    Input ``iq``: (n_frames, n_prt, n_samples, n_channels) complex with
    n_frames % dp == 0, n_prt % sp == 0, n_samples % sp == 0,
    n_channels % tp == 0, and n_beams % tp == 0.
    Returns ``(rdm, flags, vflags)`` shaped
    (n_frames, n_beams, n_prt, n_samples), beam axis sharded over tp.
    """
    cfg = cfg or profile.cfar
    pulses = reference_pulses(profile)
    coeffs = jnp.asarray(dbf_coeffs)          # (n_beams, n_channels)
    n_beams = coeffs.shape[0]
    n_sp = mesh.shape[sp_axis]
    n_tp = mesh.shape[tp_axis]
    if n_beams % n_tp:
        raise ValueError(f"n_beams {n_beams} not divisible by tp={n_tp}")
    segments = profile.cfar_segments if segmented else ()
    if segments and segments[-1][1] != profile.point_prt:
        segments = ()  # stale table for a truncated geometry — same guard
        # as make_sharded_pipeline: better whole-width CFAR than wrong
        # per-column bounds admitting wrapped halo data at the range edge

    def step(iq_local: jnp.ndarray, coeffs_local: jnp.ndarray):
        # iq_local: (frames_local, prt_local, samples, ch_local)
        # coeffs_local: (n_beams, ch_local)
        partial = jnp.einsum("fpsc,bc->fpsb", iq_local, coeffs_local)
        if n_tp > 1:
            # complete the channel sum; scatter the beam axis across tp
            beams_local = lax.psum_scatter(
                partial, tp_axis, scatter_dimension=3, tiled=True
            )
        else:
            beams_local = partial
        # (frames, prt, samples, beams_local) -> (frames, beams_local, prt, samples)
        echo = jnp.moveaxis(beams_local, -1, 1)

        n_points = echo.shape[-1]
        pc = segmented_pulse_compression(echo, profile, pulses)
        if n_sp > 1:
            pc = lax.all_to_all(pc, sp_axis, split_axis=3, concat_axis=2,
                                tiled=True)
        n_pulses = pc.shape[-2]
        window = make_window(profile.mtd.window, n_pulses,
                             profile.mtd.window_beta)
        rdm = doppler_process(pc, window, shift=profile.mtd.fftshift)
        if profile.mtd.notch_divisor:
            rdm = zero_velocity_notch(rdm, divisor=profile.mtd.notch_divisor)
        flags, vflags = sharded_cascaded_cfar2d(
            rdm, cfg, n_clutter, sp_axis, n_points, segments
        )
        return rdm, flags, vflags

    mapped = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(dp_axis, sp_axis, None, tp_axis), P(None, tp_axis)),
        out_specs=(
            P(dp_axis, tp_axis, None, sp_axis),
            P(dp_axis, tp_axis, None, sp_axis),
            P(dp_axis, tp_axis, None, sp_axis),
        ),
        check_vma=False,
    )

    @jax.jit
    def run(iq: jnp.ndarray):
        return mapped(iq, coeffs)

    return run


def shard_batch(mesh: Mesh, axis: str = "dp"):
    """NamedSharding placing the leading batch axis on ``axis``."""
    return NamedSharding(mesh, P(axis))


# ------------------------------------------------------------------ pipeline-parallel
def make_pipeline_parallel(
    profile: RadarProfile,
    mesh: Mesh,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    pp_axis: str = "pp",
    segmented: bool = True,
):
    """GPipe-style pipeline parallelism over the radar chain stages.

    The chain is cut into ``pp`` stages assigned one-per-device along the
    ``pp`` mesh axis — the radar analogue of layer pipelining:

    * 2 stages: [pulse compression | Doppler + notch + CFAR]
    * 3 stages: [pulse compression | windowed Doppler transform |
      magnitude + notch + CFAR]
    * 4 stages: [pulse compression | windowed Doppler transform |
      magnitude + notch + CFAR flag planes | cascade select] — the CFAR
      cascade split at its (vflag, rflag) materialization point, the same
      cut as ``models.detect.make_split_detector``.

    Microbatches (beams) flow through the stage ring: each tick every device
    applies its stage to its in-flight microbatch and ``ppermute``s the
    activation to the next stage while stage 0 ingests the next microbatch —
    the classic 1F schedule with ``n_micro + pp - 1`` ticks, expressed as a
    ``lax.scan`` so XLA sees one compiled loop with one collective per tick.

    Activations stay a uniform ``(n_act, n_points)`` complex64 buffer across
    the ring, where ``n_act = max(n_pulses, mtd.fft_length)`` — zero-padded
    Doppler profiles (the G0 1536 -> 2048-point MTD FFT) carry the padded
    buffer from stage 0, so the ppermute link shape is stage-independent.
    Flag planes ride the imaginary part (stage 3 encodes
    ``vflag + 2*rflag``; the final stage encodes ``rdm + 1j*flags``).

    Returns ``run(echo) -> (rdm, flags)`` for ``echo`` of shape
    ``(n_micro, n_pulses, n_points)``; results are bit-identical to the
    unsharded ``mtd_produce`` + ``segmented_cfar`` chain (every depth runs
    the same FFT Doppler transform).
    """
    cfg = cfg or profile.cfar
    pulses = reference_pulses(profile)
    n_pp = mesh.shape[pp_axis]
    if n_pp not in (2, 3, 4):
        raise ValueError(f"pipeline depth must be 2, 3 or 4, got {n_pp}")
    segments = profile.cfar_segments if segmented else ()
    if segments and segments[-1][1] != profile.point_prt:
        segments = ()

    from radar_signal_process_tpu.ops.cfar import (
        segmented_cfar,
        segmented_cfar_flags,
        segmented_cfar_select,
    )
    from radar_signal_process_tpu.ops.mtd import mti_cancel

    def _build_stages(n_pulses: int):
        """Stage closures for a given (static) echo slow-time length."""
        n_fft = profile.mtd.fft_length or n_pulses
        if n_fft < n_pulses:
            raise ValueError(
                f"mtd.fft_length {n_fft} < n_pulses {n_pulses}"
            )
        n_act = n_fft
        window = make_window(
            profile.mtd.window, n_pulses, profile.mtd.window_beta
        )

        def s_pc(x):
            # zero pad rows compress to zero, so the padded buffer passes
            # through the segmented compressor unchanged in the real rows
            return segmented_pulse_compression(x, profile, pulses)

        def _spec(x):
            # windowed Doppler spectrum of the real rows, complex.
            # Window dtype follows the input (as doppler_process does) so
            # deeper depths stay bit-identical to pp=2 for complex128 too.
            pc = x[..., :n_pulses, :]
            if profile.mtd.mti_lag:
                pc = mti_cancel(pc, lag=profile.mtd.mti_lag)
            w = jnp.asarray(window, dtype=jnp.real(x).dtype)[:, None]
            spec = jnp.fft.fft(pc * w, n=n_fft, axis=-2)
            if profile.mtd.fftshift:
                spec = jnp.fft.fftshift(spec, axes=-2)
            return spec

        def _notched(rdm):
            if profile.mtd.notch_divisor:
                rdm = zero_velocity_notch(
                    rdm, divisor=profile.mtd.notch_divisor
                )
            return rdm

        def _segs(rdm):
            return segments or ((0, rdm.shape[-1]),)

        def s_rdm_cfar(x):      # 2-stage tail: PC activation in
            # the same FFT Doppler transform at every pipeline depth, so
            # all depths produce identical bits on every backend
            rdm = _notched(jnp.abs(_spec(x)))
            flags, _ = segmented_cfar(rdm, _segs(rdm), cfg, n_clutter)
            return rdm + 1j * flags.astype(jnp.float32)

        def s_doppler_spec(x):
            # _spec emits exactly n_fft == n_act rows (the zero-padded
            # transform fills the activation buffer)
            return _spec(x)

        def s_mag_cfar(x):      # 3-stage tail: complex spectrum in
            rdm = _notched(jnp.abs(x))
            flags, _ = segmented_cfar(rdm, _segs(rdm), cfg, n_clutter)
            return rdm + 1j * flags.astype(jnp.float32)

        def s_mag_flags(x):     # 4-stage: flag planes ride the imag part
            rdm = _notched(jnp.abs(x))
            vflag, rflag = segmented_cfar_flags(
                rdm, _segs(rdm), cfg, n_clutter
            )
            enc = vflag.astype(jnp.float32) + 2.0 * rflag.astype(jnp.float32)
            lo = n_clutter + 1
            enc_full = jnp.zeros(rdm.shape, jnp.float32)
            enc_full = jax.lax.dynamic_update_slice_in_dim(
                enc_full, enc, lo, axis=-2
            )
            return rdm + 1j * enc_full

        def s_select(x):        # 4-stage tail: resolve cascade winners
            rdm = jnp.real(x)
            enc = jnp.imag(x)
            lo, hi = n_clutter + 1, rdm.shape[-2] - n_clutter
            enc_used = enc[..., lo:hi, :]
            vflag = jnp.mod(enc_used, 2.0) >= 0.5
            rflag = enc_used >= 1.5
            flags, _ = segmented_cfar_select(
                rdm, vflag, rflag, _segs(rdm), cfg, n_clutter
            )
            return rdm + 1j * flags.astype(jnp.float32)

        if n_pp == 2:
            stages = [s_pc, s_rdm_cfar]
        elif n_pp == 3:
            stages = [s_pc, s_doppler_spec, s_mag_cfar]
        else:
            stages = [s_pc, s_doppler_spec, s_mag_flags, s_select]
        return stages, n_act

    import functools

    @functools.lru_cache(maxsize=None)
    def _make_mapped(n_pulses: int):
        """shard_map'ed ring for one (static) echo slow-time length."""
        stages, n_act = _build_stages(n_pulses)

        def pipe(echo):
            # echo: (n_micro, n_act, n_points) — replicated; stage 0 ingests
            n_micro = echo.shape[0]
            ticks = n_micro + n_pp - 1
            stage = lax.axis_index(pp_axis)
            to_next = [(i, (i + 1) % n_pp) for i in range(n_pp)]

            def stage_fn(x):
                return lax.switch(stage, stages, x)

            # xs[t] is what stage 0 ingests for tick t+1 (tick 0: echo[0])
            pad = jnp.zeros((n_pp - 1,) + echo.shape[1:], echo.dtype)
            xs = jnp.concatenate([echo[1:], pad, pad[:1]], axis=0)[:ticks]

            def body(buf, x_t):
                y = stage_fn(buf)
                recv = lax.ppermute(y, pp_axis, to_next)
                buf_next = jnp.where(stage == 0, x_t, recv)
                return buf_next, y

            buf0 = jnp.where(stage == 0, echo[0], jnp.zeros_like(echo[0]))
            _, ys = lax.scan(body, buf0, xs)
            return ys[None]      # (1, ticks, n_act, n_points) per stage

        mapped = jax.shard_map(
            pipe,
            mesh=mesh,
            in_specs=P(),            # replicated input
            out_specs=P(pp_axis),    # (n_pp, ticks, ...) stacked by stage
            check_vma=False,
        )
        return mapped, n_act

    @jax.jit
    def run(echo: jnp.ndarray):
        mapped, n_act = _make_mapped(echo.shape[-2])
        if echo.shape[-2] < n_act:
            echo = jnp.pad(
                echo, ((0, 0), (0, n_act - echo.shape[-2]), (0, 0))
            )
        ys = mapped(echo)
        out = ys[-1, n_pp - 1 : n_pp - 1 + echo.shape[0]]  # drained tail
        return jnp.real(out), jnp.imag(out) > 0.5

    return run


# ------------------------------------------------------------------ expert-parallel
def make_expert_parallel(
    profile: RadarProfile,
    mesh: Mesh,
    calibrations,
    ep_axis: str = "ep",
    capacity: int | None = None,
):
    """Expert parallelism: per-beam calibration experts with MoE routing.

    The radar analogue of mixture-of-experts: each beam position has its own
    receive-gain calibration curve (the per-beam-dependent parameters the
    reference bakes into its K-value / angle tables), and the full table is
    too large to replicate at scale — so the curves are SHARDED across the
    ``ep`` mesh axis, one beam-group of "experts" per device.  Frames are
    routed to the device owning their beam's expert with the standard MoE
    dispatch: sort by destination, pack per-destination buckets of static
    ``capacity``, one ``all_to_all``, expert-local compute (calibration +
    segmented pulse compression), and a second ``all_to_all`` + un-scatter to
    restore frame order.

    Frames beyond a bucket's capacity are dropped (zero output), exactly like
    MoE token dropping; the default capacity (``F_local``, the worst case)
    never drops — pass a tighter ``capacity`` (e.g. the MoE-style
    ``factor * F_local // n_ep``) to trade padding for drops.

    ``calibrations``: (n_beams, n_points) real gain curves; n_beams must be
    divisible by mesh["ep"].  Returns ``run(frames, beam_ids) ->
    compressed`` with frames (n_frames, n_pulses, n_points) complex and
    beam_ids (n_frames,) int32; output matches
    ``segmented_pulse_compression(frames * calibrations[beam_ids][:, None, :])``
    for every routed frame.
    """
    pulses = reference_pulses(profile)
    cal = jnp.asarray(calibrations)
    n_beams = cal.shape[0]
    n_ep = mesh.shape[ep_axis]
    if n_beams % n_ep:
        raise ValueError(f"n_beams {n_beams} not divisible by ep={n_ep}")
    beams_per = n_beams // n_ep

    def step(x_local, bid_local, cal_local):
        # x_local: (F, prt, pts); bid_local: (F,); cal_local: (beams_per, pts)
        f_local = x_local.shape[0]
        cap = capacity or f_local
        dest = bid_local // beams_per                      # owning device
        order = jnp.argsort(dest, stable=True)
        sdest = dest[order]
        group_start = jnp.searchsorted(sdest, jnp.arange(n_ep), side="left")
        rank = jnp.arange(f_local) - group_start[sdest]
        kept = rank < cap
        slot = jnp.where(kept, rank, cap)                  # cap = out of bounds

        send = jnp.zeros((n_ep, cap) + x_local.shape[1:], x_local.dtype)
        send = send.at[sdest, slot].set(x_local[order], mode="drop")
        send_bid = jnp.full((n_ep, cap), -1, jnp.int32)
        send_bid = send_bid.at[sdest, slot].set(
            bid_local[order].astype(jnp.int32), mode="drop"
        )

        recv = lax.all_to_all(send, ep_axis, split_axis=0, concat_axis=0,
                              tiled=True)
        recv_bid = lax.all_to_all(send_bid, ep_axis, split_axis=0,
                                  concat_axis=0, tiled=True)

        # expert-local compute: calibrate by the frame's own beam curve,
        # then compress.  Invalid slots (bid -1) produce zeros.
        local_beam = recv_bid - lax.axis_index(ep_axis) * beams_per
        valid = recv_bid >= 0
        gain = cal_local[jnp.clip(local_beam, 0, beams_per - 1)]  # (n_ep, cap, pts)
        y = recv * jnp.where(valid[..., None], gain, 0.0)[..., None, :].astype(
            recv.dtype
        )
        y = segmented_pulse_compression(y, profile, pulses)

        back = lax.all_to_all(y, ep_axis, split_axis=0, concat_axis=0,
                              tiled=True)
        gathered = back[sdest, jnp.clip(slot, 0, cap - 1)]
        gathered = jnp.where(kept[:, None, None], gathered, 0.0)
        out = jnp.zeros_like(gathered)
        out = out.at[order].set(gathered)
        return out

    mapped = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(ep_axis), P(ep_axis), P(ep_axis, None)),
        out_specs=P(ep_axis),
        check_vma=False,
    )

    @jax.jit
    def _run(frames: jnp.ndarray, beam_ids: jnp.ndarray):
        # the calibration table enters SHARDED over ep (the expert axis):
        # device d holds rows [d*beams_per, (d+1)*beams_per)
        return mapped(frames, beam_ids, cal)

    def run(frames: jnp.ndarray, beam_ids: jnp.ndarray):
        # Host-side id validation: an out-of-range beam_id would otherwise
        # be scatter-dropped (mode="drop") — zero output indistinguishable
        # from capacity overflow.  Capacity drops are MoE semantics; bogus
        # ids are caller bugs and must raise.
        ids = np.asarray(beam_ids)
        if ids.size and (ids.min() < 0 or ids.max() >= n_beams):
            bad = ids[(ids < 0) | (ids >= n_beams)]
            raise ValueError(
                f"beam_ids out of range [0, {n_beams}): {bad[:8].tolist()}"
            )
        return _run(frames, beam_ids)

    return run
