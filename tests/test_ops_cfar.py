"""Golden tests: CFAR ops vs the NumPy oracle (exact flag equality)."""

import jax.numpy as jnp
import numpy as np
import pytest

from radar_signal_process_tpu.config import CFARConfig
from radar_signal_process_tpu.ops import cascaded_cfar2d, cfar1d, segmented_cfar
from tests.oracle import cfar as oracle


def _rdm_with_targets(rng, nv=128, nr=96, n_targets=6, snr=30.0):
    rdm = np.abs(rng.standard_normal((nv, nr))) + 0.5
    for _ in range(n_targets):
        v = rng.integers(10, nv - 10)
        r = rng.integers(0, nr)
        rdm[v, r] += snr
    return rdm


@pytest.mark.parametrize("method", [0, 1], ids=["GO", "SO"])
def test_cfar1d_matches_oracle(rng, method):
    data = _rdm_with_targets(rng)
    got = np.asarray(
        cfar1d(jnp.asarray(data), ref_cells=5, guard_cells=7, threshold=5.0,
               method=method, axis=-1)
    )
    want = oracle.cfar1d_sub(data, 5, 7, 5.0, method).astype(bool)
    np.testing.assert_array_equal(got, want)


def test_cfar1d_velocity_axis(rng):
    data = _rdm_with_targets(rng)
    got = np.asarray(
        cfar1d(jnp.asarray(data), 5, 7, 5.0, 0, axis=-2)
    )
    want = oracle.cfar1d_sub(data.T, 5, 7, 5.0, 0).T.astype(bool)
    np.testing.assert_array_equal(got, want)


def test_cfar1d_small_segment_edges(rng):
    # narrow G1 segment has only 82 columns: both edge fallbacks exercised
    data = np.abs(rng.standard_normal((20, 82))) + 0.1
    data[:, 2] += 50.0
    data[:, 80] += 50.0
    got = np.asarray(cfar1d(jnp.asarray(data), 5, 7, 5.0, 0))
    want = oracle.cfar1d_sub(data, 5, 7, 5.0, 0).astype(bool)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_clutter", [6, 11])
def test_cascaded_cfar2d_matches_oracle(rng, n_clutter):
    rdm = _rdm_with_targets(rng, nv=160, nr=120)
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0, method=0)
    flags, vflags = cascaded_cfar2d(jnp.asarray(rdm), cfg, n_clutter)
    want_f, want_v = oracle.execute_cfar(
        rdm, 5, 7, 5.0, 0, 5, 7, 5.0, 0, n_clutter, True
    )
    np.testing.assert_array_equal(np.asarray(vflags), want_v.astype(bool))
    np.testing.assert_array_equal(np.asarray(flags), want_f.astype(bool))


def test_cascaded_cfar2d_no_range_pass(rng):
    rdm = _rdm_with_targets(rng)
    cfg = CFARConfig(threshold=5.0, range_detect=False)
    flags, vflags = cascaded_cfar2d(jnp.asarray(rdm), cfg, 6)
    want_f, want_v = oracle.execute_cfar(rdm, 5, 7, 5.0, 0, 5, 7, 5.0, 0, 6, False)
    np.testing.assert_array_equal(np.asarray(flags), want_f.astype(bool))
    np.testing.assert_array_equal(np.asarray(vflags), want_v.astype(bool))


def test_cascaded_cfar2d_batched(rng):
    rdms = np.stack([_rdm_with_targets(rng) for _ in range(3)])
    cfg = CFARConfig(threshold=5.0)
    flags, _ = cascaded_cfar2d(jnp.asarray(rdms), cfg, 6)
    for b in range(3):
        want_f, _ = oracle.execute_cfar(rdms[b], 5, 7, 5.0, 0, 5, 7, 5.0, 0, 6, True)
        np.testing.assert_array_equal(np.asarray(flags[b]), want_f.astype(bool))


def test_segmented_cfar_matches_per_segment_oracle(rng):
    rdm = _rdm_with_targets(rng, nv=155, nr=868)
    segments = ((0, 82), (82, 318), (318, 868))
    cfg = CFARConfig(threshold=5.0)
    flags, vflags = segmented_cfar(jnp.asarray(rdm), segments, cfg, 6)
    for start, stop in segments:
        want_f, want_v = oracle.execute_cfar(
            rdm[:, start:stop], 5, 7, 5.0, 0, 5, 7, 5.0, 0, 6, True
        )
        np.testing.assert_array_equal(
            np.asarray(flags[:, start:stop]), want_f.astype(bool)
        )
        np.testing.assert_array_equal(
            np.asarray(vflags[:, start:stop]), want_v.astype(bool)
        )


def test_cascade_tie_break_on_equal_amplitudes(rng):
    """ADVICE r1: pin the ext==1 fast path's first-maximum tie-break.

    Quantized amplitudes make exact ties between the -1/0/+1 range
    candidates frequent; the fast branch-free form must still match the
    oracle's loop semantics (MATLAB ``max`` keeps the first maximum, i.e.
    offset -1 beats 0 beats +1) cell for cell.
    """
    rdm = rng.integers(1, 5, size=(64, 48)).astype(np.float64)
    cfg = CFARConfig(ref_cells=2, guard_cells=1, threshold=1.0, method=0,
                     range_extend_cells=1)
    flags, vflags = cascaded_cfar2d(jnp.asarray(rdm), cfg, 4)
    want_f, want_v = oracle.execute_cfar(
        rdm, 2, 1, 1.0, 0, 2, 1, 1.0, 0, 4, True, range_cell_nums=1
    )
    assert np.asarray(vflags).sum() > 0  # ties actually exercised
    np.testing.assert_array_equal(np.asarray(vflags), want_v.astype(bool))
    np.testing.assert_array_equal(np.asarray(flags), want_f.astype(bool))


def test_cascade_tie_break_fast_path_equals_loop_path(rng):
    """The ext==1 fused form and the general loop form agree on tie-heavy data.

    The loop path is forced with ``range_extend_cells=2`` on data whose
    columns are padded so cells at offset +-2 can never hold a range flag:
    every odd column is zeroed, so range hits only occur on even columns
    and the +-2 candidates compete only through the +-1/0 positions.
    """
    rdm = rng.integers(1, 4, size=(48, 40)).astype(np.float64)
    cfg1 = CFARConfig(ref_cells=2, guard_cells=1, threshold=1.0, method=0,
                      range_extend_cells=1)
    cfg2 = CFARConfig(ref_cells=2, guard_cells=1, threshold=1.0, method=0,
                      range_extend_cells=2)
    want_f1, _ = oracle.execute_cfar(
        rdm, 2, 1, 1.0, 0, 2, 1, 1.0, 0, 4, True, range_cell_nums=1
    )
    want_f2, _ = oracle.execute_cfar(
        rdm, 2, 1, 1.0, 0, 2, 1, 1.0, 0, 4, True, range_cell_nums=2
    )
    got1, _ = cascaded_cfar2d(jnp.asarray(rdm), cfg1, 4)   # fast path
    got2, _ = cascaded_cfar2d(jnp.asarray(rdm), cfg2, 4)   # loop path
    np.testing.assert_array_equal(np.asarray(got1), want_f1.astype(bool))
    np.testing.assert_array_equal(np.asarray(got2), want_f2.astype(bool))


def test_split_cfar_matches_one_executable(rng):
    """The two-executable split cascade is bit-identical to segmented_cfar.

    Covers the G2 segment split, a batched RDM stack, tie-heavy quantized
    amplitudes, and the range_detect=False degenerate path.
    """
    from radar_signal_process_tpu.ops import (
        segmented_cfar_flags,
        segmented_cfar_select,
    )

    segs = ((0, 30), (30, 104), (104, 220))
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0, method=0,
                     range_extend_cells=1)
    for data in (
        _rdm_with_targets(rng, nv=160, nr=220).astype(np.float32),
        _rdm_with_targets(rng, nv=160, nr=220),          # float64
        rng.integers(1, 4, size=(160, 220)).astype(np.float32),  # tie-heavy
        np.abs(rng.standard_normal((3, 160, 220))).astype(np.float32) + 0.3,
    ):
        rdm = jnp.asarray(data)
        want_f, want_v = segmented_cfar(rdm, segs, cfg, 11)
        vf, rf = segmented_cfar_flags(rdm, segs, cfg, 11)
        got_f, got_v = segmented_cfar_select(rdm, vf, rf, segs, cfg, 11)
        np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
        np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))

    cfg_nov = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0, method=0,
                         range_detect=False)
    rdm = jnp.asarray(_rdm_with_targets(rng, nv=160, nr=220))
    want_f, want_v = segmented_cfar(rdm, segs, cfg_nov, 11)
    vf, rf = segmented_cfar_flags(rdm, segs, cfg_nov, 11)
    got_f, got_v = segmented_cfar_select(rdm, vf, rf, segs, cfg_nov, 11)
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))


def test_split_cfar_general_extension(rng):
    """Split select stage agrees with the loop form for ext > 1."""
    from radar_signal_process_tpu.ops import (
        segmented_cfar_flags,
        segmented_cfar_select,
    )

    segs = ((0, 64), (64, 120))
    cfg = CFARConfig(ref_cells=2, guard_cells=1, threshold=1.5, method=0,
                     range_extend_cells=2)
    rdm = jnp.asarray(rng.integers(1, 5, size=(80, 120)).astype(np.float32))
    want_f, want_v = segmented_cfar(rdm, segs, cfg, 6)
    vf, rf = segmented_cfar_flags(rdm, segs, cfg, 6)
    got_f, got_v = segmented_cfar_select(rdm, vf, rf, segs, cfg, 6)
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))


def test_make_split_detector_matches_detect_rdm(rng):
    """models.make_split_detector == detect_rdm on the G2 profile (both notch
    orderings), including the unshifted-spectrum (G0) renotch branch."""
    import dataclasses

    from radar_signal_process_tpu.config import G0_PROFILE, G2_PROFILE
    from radar_signal_process_tpu.models.detect import (
        detect_rdm,
        make_split_detector,
    )

    cfg = CFARConfig(threshold=5.0)
    rdm = jnp.asarray(
        np.abs(rng.standard_normal((2, 120, 300))).astype(np.float32) + 0.2
    )
    prof = dataclasses.replace(G2_PROFILE, cfar_segments=((0, 90), (90, 300)))
    want_f, want_v = detect_rdm(rdm, prof, 11, cfg=cfg)
    det = make_split_detector(prof, 11, cfg=cfg)
    got_f, got_v = det(rdm)
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))

    prof0 = dataclasses.replace(G0_PROFILE, cfar_segments=None)
    want_f, want_v = detect_rdm(rdm, prof0, 11, cfg=cfg)
    det0 = make_split_detector(prof0, 11, cfg=cfg)
    got_f, got_v = det0(rdm)
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))


def test_split_cfar_transposed_layout(rng):
    """transposed=True on (..., n_r, n_v) RDMs matches the canonical layout."""
    from radar_signal_process_tpu.ops import (
        segmented_cfar_flags,
        segmented_cfar_select,
    )

    segs = ((0, 30), (30, 104), (104, 220))
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0, method=0,
                     range_extend_cells=1)
    for ext in (1, 2):
        import dataclasses

        c = dataclasses.replace(cfg, range_extend_cells=ext)
        data = _rdm_with_targets(rng, nv=160, nr=220).astype(np.float32)
        rdm = jnp.asarray(data)
        want_f, want_v = segmented_cfar(rdm, segs, c, 11)
        vf, rf = segmented_cfar_flags(rdm.T, segs, c, 11, transposed=True)
        got_f, got_v = segmented_cfar_select(
            rdm.T, vf, rf, segs, c, 11, transposed=True
        )
        np.testing.assert_array_equal(np.asarray(got_v).T, np.asarray(want_v))
        np.testing.assert_array_equal(np.asarray(got_f).T, np.asarray(want_f))


def test_doppler_range_major_and_transposed_detector(rng):
    """range-major Doppler + transposed split detector == canonical chain."""
    import dataclasses

    from radar_signal_process_tpu.config import G2_PROFILE
    from radar_signal_process_tpu.models.detect import (
        detect_rdm,
        make_split_detector,
    )
    from radar_signal_process_tpu.ops import (
        doppler_process,
        doppler_process_range_major,
        make_window,
        zero_velocity_notch,
    )

    pc = jnp.asarray(
        (rng.standard_normal((64, 300)) + 1j * rng.standard_normal((64, 300)))
        .astype(np.complex64)
    )
    window = make_window("kaiser", 64, 8.0)
    rdm = zero_velocity_notch(doppler_process(pc, window), divisor=150)
    rdm_t = zero_velocity_notch(
        doppler_process_range_major(pc, window), divisor=150, velocity_axis=-1
    )
    np.testing.assert_array_equal(np.asarray(rdm).T, np.asarray(rdm_t))

    prof = dataclasses.replace(G2_PROFILE, cfar_segments=((0, 90), (90, 300)))
    cfg = CFARConfig(threshold=5.0)
    want_f, want_v = detect_rdm(rdm, prof, 7, cfg=cfg)
    det_t = make_split_detector(prof, 7, cfg=cfg, transposed=True)
    got_f, got_v = det_t(rdm_t)
    np.testing.assert_array_equal(np.asarray(got_f).T, np.asarray(want_f))
    np.testing.assert_array_equal(np.asarray(got_v).T, np.asarray(want_v))


def test_cfar_ref_level_sweep_matches_full_cascade(rng):
    """Precomputed ref levels + traced threshold == segmented_cfar per T."""
    import dataclasses

    from radar_signal_process_tpu.ops import (
        segmented_cfar_from_ref_levels,
        segmented_cfar_ref_levels,
    )

    segs = ((0, 64), (64, 180))
    rdm = jnp.asarray(_rdm_with_targets(rng, nv=140, nr=180).astype(np.float32))
    base = CFARConfig(ref_cells=5, guard_cells=7, threshold=1.0, method=0)
    vref, rref = segmented_cfar_ref_levels(rdm, segs, base, 9)
    for t in (2.0, 5.0, 9.5):
        cfg_t = dataclasses.replace(base, threshold=t)
        want_f, want_v = segmented_cfar(rdm, segs, cfg_t, 9)
        got_f, got_v = segmented_cfar_from_ref_levels(
            rdm, vref, rref, t, segs, base, 9
        )
        np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))
        np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
