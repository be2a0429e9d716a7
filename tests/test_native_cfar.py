"""Native C++ CFAR cascade == jitted split cascade, exactly.

The native kernel (kernels/native/cfar.cpp) is the THIRD lockstep CFAR
implementation (CLAUDE.md parity conventions): bit-identical flags to
ops.cfar's split form on every input class, including the notched all-zero
rows that self-flag (0 >= 0) and the edge-validity fallbacks.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from radar_signal_process_tpu.config import CFARConfig
from radar_signal_process_tpu.kernels.native_cfar import (
    build_error,
    make_native_cascade,
    native_cfar_available,
    notch_mask_shifted,
    notch_mask_unshifted,
)
from radar_signal_process_tpu.ops.cfar import (
    segmented_cfar_flags,
    segmented_cfar_select,
)
from radar_signal_process_tpu.ops.mtd import (
    zero_velocity_notch,
    zero_velocity_notch_unshifted,
)

pytestmark = pytest.mark.skipif(
    not native_cfar_available(),
    reason=f"native CFAR unavailable: {build_error()}",
)


def _jitted(rdm_t, segments, cfg, n_clutter, renotch=None, unshifted=False):
    x = jnp.asarray(rdm_t)
    if renotch:
        if unshifted:
            x = zero_velocity_notch_unshifted(x, n_clutter, velocity_axis=-1)
        else:
            x = zero_velocity_notch(x, divisor=renotch, velocity_axis=-1)
    segs = segments or ((0, rdm_t.shape[0]),)
    vf, rf = segmented_cfar_flags(x, segs, cfg, n_clutter, transposed=True)
    f, v = segmented_cfar_select(x, vf, rf, segs, cfg, n_clutter,
                                 transposed=True)
    return np.asarray(f), np.asarray(v)


def _check(rdm_t, segments, cfg, n_clutter, renotch=None, unshifted=False):
    if renotch is None:
        mask = None
    elif unshifted:
        mask = notch_mask_unshifted(rdm_t.shape[1], n_clutter)
    else:
        mask = notch_mask_shifted(rdm_t.shape[1], renotch)
    native = make_native_cascade(n_clutter, cfg, segments=segments,
                                 notch_mask=mask)
    got_f, got_v = native(rdm_t)
    want_f, want_v = _jitted(rdm_t, segments, cfg, n_clutter,
                             renotch=renotch, unshifted=unshifted)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


def test_native_cascade_matches_split_basic(rng):
    rdm_t = (rng.standard_normal((96, 48)).astype(np.float32)) ** 2
    cfg = CFARConfig(ref_cells=3, guard_cells=2, threshold=3.0)
    _check(rdm_t, ((0, 40), (40, 96)), cfg, n_clutter=4, renotch=20)


def test_native_cascade_notched_zero_rows(rng):
    """All-zero notched columns self-flag (0 >= 0) exactly like the jitted
    form — the class that exposed the round-3 sharded-halo bug."""
    rdm_t = np.abs(rng.standard_normal((64, 40))).astype(np.float32)
    cfg = CFARConfig(ref_cells=2, guard_cells=1, threshold=5.0)
    _check(rdm_t, ((0, 64),), cfg, n_clutter=3, renotch=8)


def test_native_cascade_method_so_and_no_range(rng):
    rdm_t = (rng.standard_normal((50, 36)).astype(np.float32)) ** 2
    so = CFARConfig(ref_cells=4, guard_cells=3, threshold=2.0, method=1)
    _check(rdm_t, ((0, 50),), so, n_clutter=2)
    no_r = CFARConfig(ref_cells=3, guard_cells=2, threshold=3.0,
                      range_detect=False)
    _check(rdm_t, ((0, 50),), no_r, n_clutter=2)


def test_native_cascade_general_ext(rng):
    """ext=2 exercises the strict-> running-argmax general path."""
    rdm_t = (rng.standard_normal((80, 44)).astype(np.float32)) ** 2
    cfg = CFARConfig(ref_cells=3, guard_cells=2, threshold=2.5,
                     range_extend_cells=2)
    _check(rdm_t, ((0, 30), (30, 80)), cfg, n_clutter=3, renotch=10)


def test_native_cascade_unshifted_notch(rng):
    rdm_t = (rng.standard_normal((60, 64)).astype(np.float32)) ** 2
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=4.0)
    _check(rdm_t, ((0, 60),), cfg, n_clutter=6, renotch=20, unshifted=True)


def test_native_cascade_short_segments_edge_fallback(rng):
    """Segments shorter than 2*(ref+guard): both windows partially invalid,
    the edge-fallback select must match exactly."""
    rdm_t = (rng.standard_normal((40, 40)).astype(np.float32)) ** 2
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=1.5)
    _check(rdm_t, ((0, 14), (14, 40)), cfg, n_clutter=2, renotch=20)


def test_native_cascade_g2_geometry_fuzz(rng):
    """Full G2 geometry (3404 x 332, three segments, defaults) with ties
    (quantized amplitudes force equal-value cascade candidates)."""
    rdm_t = np.round(
        (rng.standard_normal((3404, 332)).astype(np.float32)) ** 2 * 4
    ) / 4
    cfg = CFARConfig(threshold=5.0)
    segs = ((0, 82), (82, 318), (318, 3404))
    _check(rdm_t, segs, cfg, n_clutter=14, renotch=20)


def test_native_cascade_ties_first_max_wins(rng):
    """Exact-tie amplitudes across neighboring candidates: MATLAB max
    semantics (first maximum wins) in both forms."""
    rdm_t = np.ones((30, 30), np.float32)
    rdm_t[10:20, :] = 7.0   # plateau of identical values
    cfg = CFARConfig(ref_cells=2, guard_cells=1, threshold=1.0)
    _check(rdm_t, ((0, 30),), cfg, n_clutter=2)
    cfg2 = dataclasses.replace(cfg, range_extend_cells=2)
    _check(rdm_t, ((0, 30),), cfg2, n_clutter=2)


def test_native_cascade_in_stream_pipeline(rng, monkeypatch):
    """RSP_NATIVE_CFAR=1 routes the production stream's cascade through the
    C++ kernel; results are bit-identical to the default jitted path."""
    from radar_signal_process_tpu.config import G2_PROFILE
    from radar_signal_process_tpu.models.host_parallel import (
        make_cpu_stream_pipeline,
    )

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)), n_beams=3,
    )
    shape = (prof.n_beams, prof.prt_per_frame, prof.point_prt)
    frames = [
        jnp.asarray((rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape)).astype(np.complex64))
        for _ in range(3)
    ]

    def collect():
        run = make_cpu_stream_pipeline(prof, 4, 4, max_detections=8)
        got = {}
        run(frames, lambda w, r, f, d, h: got.__setitem__(w, (r, f, d, h)))
        return got

    monkeypatch.delenv("RSP_NATIVE_CFAR", raising=False)
    want = collect()
    monkeypatch.setenv("RSP_NATIVE_CFAR", "1")
    got = collect()
    assert sorted(got) == sorted(want) == [0, 1]
    for w in want:
        np.testing.assert_array_equal(got[w][0], want[w][0])   # rdms
        np.testing.assert_array_equal(got[w][1], want[w][1])   # flags
        assert got[w][3] == want[w][3]                         # hits
        np.testing.assert_array_equal(got[w][2].valid, want[w][2].valid)
        np.testing.assert_array_equal(got[w][2].amplitude,
                                      want[w][2].amplitude)


def test_native_cascade_random_config_fuzz(rng):
    """Random (geometry, cfg, segments, notch) draws: native == jitted
    exactly on every draw."""
    for _ in range(8):
        n_r = int(rng.integers(30, 200))
        n_v = int(rng.integers(24, 80))
        n_clutter = int(rng.integers(1, max(2, n_v // 6)))
        cfg = CFARConfig(
            ref_cells=int(rng.integers(1, 6)),
            guard_cells=int(rng.integers(0, 8)),
            threshold=float(rng.uniform(0.5, 6.0)),
            method=int(rng.integers(0, 2)),
            range_detect=bool(rng.integers(0, 2)),
            range_extend_cells=int(rng.integers(1, 4)),
        )
        n_segs = int(rng.integers(1, 4))
        cuts = sorted(rng.choice(np.arange(5, n_r - 5), size=n_segs - 1,
                                 replace=False).tolist()) if n_segs > 1 else []
        bounds = [0] + [int(c) for c in cuts] + [n_r]
        segments = tuple(
            (bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
        )
        renotch = int(rng.choice([0, 8, 20]))
        rdm_t = (rng.standard_normal((n_r, n_v)).astype(np.float32)) ** 2
        _check(rdm_t, segments, cfg, n_clutter,
               renotch=renotch or None)


def test_native_cascade_rejects_bad_segments(rng):
    """Out-of-range segment tables fail loud before reaching the C side."""
    rdm_t = np.ones((20, 30), np.float32)
    cfg = CFARConfig(ref_cells=2, guard_cells=1, threshold=2.0)
    for segs in (((0, 25),), ((-2, 10),), ((10, 10),)):
        native = make_native_cascade(2, cfg, segments=segs)
        with pytest.raises(ValueError, match="segment"):
            native(rdm_t)
    with pytest.raises(ValueError, match="2-D"):
        make_native_cascade(2, cfg)(np.ones((2, 20, 30), np.float32))
