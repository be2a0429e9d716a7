"""Multi-device tests on the virtual CPU mesh: sharded vs unsharded parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from radar_signal_process_tpu.config import CFARConfig, G2_PROFILE
from radar_signal_process_tpu.models.mtd_pipeline import mtd_produce
from radar_signal_process_tpu.ops.cfar import (
    cascaded_cfar2d,
    cfar1d_ref_level,
    segmented_cfar,
)
from radar_signal_process_tpu.parallel import make_mesh
from radar_signal_process_tpu.parallel.sharding import (
    make_sharded_pipeline,
    sharded_cascaded_cfar2d,
    sharded_cfar1d_ref_level,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect the 8-device CPU mesh"
    return make_mesh(("dp", "sp"), shape=(2, 4))


def test_sharded_ref_level_matches_unsharded(rng, mesh):
    data = np.abs(rng.standard_normal((32, 128))) + 0.1
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0)
    want = cfar1d_ref_level(jnp.asarray(data), 5, 7, 0, axis=-1)

    def local(x):
        return sharded_cfar1d_ref_level(x, cfg, "sp", 128)

    got = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(None, "sp"), out_specs=P(None, "sp")
        )
    )(jnp.asarray(data))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


def test_sharded_cascade_matches_unsharded(rng, mesh):
    nv, nr = 96, 160
    rdm = np.abs(rng.standard_normal((nv, nr))) + 0.5
    for _ in range(8):
        rdm[rng.integers(8, nv - 8), rng.integers(0, nr)] += 40.0
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0)
    n_clutter = 6

    want_f, want_v = cascaded_cfar2d(jnp.asarray(rdm), cfg, n_clutter)

    def local(x):
        return sharded_cascaded_cfar2d(x, cfg, n_clutter, "sp", nr)

    got_f, got_v = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=P(None, "sp"),
            out_specs=(P(None, "sp"), P(None, "sp")),
        )
    )(jnp.asarray(rdm))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))


def test_sharded_segmented_cascade_matches_unsharded(rng, mesh):
    """Per-pulse-segment CFAR with shard boundaries that do NOT align with
    the segment boundaries: per-column validity bounds must confine every
    reference window and cascade candidate to its own segment."""
    nv, nr = 96, 160
    segments = ((0, 24), (24, 88), (88, 160))  # shard width is 40
    rdm = np.abs(rng.standard_normal((nv, nr))) + 0.5
    for _ in range(10):
        rdm[rng.integers(8, nv - 8), rng.integers(0, nr)] += 40.0
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0)
    n_clutter = 6

    want_f, want_v = segmented_cfar(jnp.asarray(rdm), segments, cfg, n_clutter)

    def local(x):
        return sharded_cascaded_cfar2d(x, cfg, n_clutter, "sp", nr, segments)

    got_f, got_v = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=P(None, "sp"),
            out_specs=(P(None, "sp"), P(None, "sp")),
        )
    )(jnp.asarray(rdm))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))


def test_sharded_pipeline_matches_unsharded(rng, mesh):
    """Full step: PRT-sharded PC -> all_to_all -> range-sharded MTD+CFAR."""
    prof = G2_PROFILE
    n_beams, n_prt = 2, 64
    n_pts = prof.point_prt  # 3404 = 4 * 851
    echo = (
        rng.standard_normal((n_beams, n_prt, n_pts))
        + 1j * rng.standard_normal((n_beams, n_prt, n_pts))
    )
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0)
    n_clutter = 6

    run = make_sharded_pipeline(prof, mesh, cfg, n_clutter)
    x = jax.device_put(
        jnp.asarray(echo), NamedSharding(mesh, P("dp", "sp", None))
    )
    rdm_s, flags_s, vflags_s = run(x)

    rdm_u = mtd_produce(jnp.asarray(echo), prof)
    # the pipeline honors the reference's per-pulse-segment CFAR split
    flags_u, vflags_u = segmented_cfar(rdm_u, prof.cfar_segments, cfg, n_clutter)

    np.testing.assert_allclose(np.asarray(rdm_s), np.asarray(rdm_u), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(vflags_s), np.asarray(vflags_u))
    np.testing.assert_array_equal(np.asarray(flags_s), np.asarray(flags_u))


def test_dp_batch_sharding_runs(rng, mesh):
    prof = G2_PROFILE
    echo = rng.standard_normal((4, 32, prof.point_prt)).astype(np.complex128)
    x = jax.device_put(jnp.asarray(echo), NamedSharding(mesh, P("dp", None, None)))
    rdm = jax.jit(lambda e: mtd_produce(e, prof))(x)
    assert rdm.shape == echo.shape


def test_multihost_helpers_single_process():
    from radar_signal_process_tpu.parallel.multihost import (
        host_frame_assignment,
        initialize_distributed,
    )

    pid, n = initialize_distributed()
    assert (pid, n) == (0, 1)
    assert list(host_frame_assignment(10, 0, 1)) == list(range(10))
    # two hosts: ranges overlap by one frame for the CPI pair window
    a = list(host_frame_assignment(10, 0, 2))
    b = list(host_frame_assignment(10, 1, 2))
    assert a == [0, 1, 2, 3, 4, 5]
    assert b == [5, 6, 7, 8, 9]
    assert set(a) | set(b) == set(range(10))


def test_sharded_e2e_tp_dbf_matches_unsharded(rng):
    """3-axis mesh: tp-sharded DBF (psum_scatter) + sp pipeline vs unsharded.

    The DBF contraction is split across tp devices, so the channel sum
    order differs from the single einsum — RDMs compare with a tight
    tolerance; CFAR flags must still agree exactly on this data.
    """
    import dataclasses

    from radar_signal_process_tpu.ops.dbf import apply_dbf
    from radar_signal_process_tpu.parallel.sharding import make_sharded_e2e

    mesh3 = make_mesh(("dp", "sp", "tp"), shape=(2, 2, 2))
    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
        n_channels=4, n_beams=4,
    )
    n_frames, n_prt, n_pts, n_ch = 2, 32, 344, 4
    iq = (
        rng.standard_normal((n_frames, n_prt, n_pts, n_ch))
        + 1j * rng.standard_normal((n_frames, n_prt, n_pts, n_ch))
    )
    coeffs = (
        rng.standard_normal((4, n_ch)) + 1j * rng.standard_normal((4, n_ch))
    )
    cfg = CFARConfig(ref_cells=3, guard_cells=4, threshold=5.0)

    run = make_sharded_e2e(prof, mesh3, coeffs, cfg, n_clutter=4)
    x = jax.device_put(
        jnp.asarray(iq), NamedSharding(mesh3, P("dp", "sp", None, "tp"))
    )
    rdm_s, flags_s, vflags_s = run(x)

    echo = jnp.moveaxis(apply_dbf(jnp.asarray(iq), jnp.asarray(coeffs)), -1, 1)
    rdm_u = mtd_produce(echo, prof)
    flags_u, vflags_u = segmented_cfar(rdm_u, prof.cfar_segments, cfg, 4)

    assert rdm_s.shape == (n_frames, 4, n_prt, n_pts)
    np.testing.assert_allclose(
        np.asarray(rdm_s), np.asarray(rdm_u), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_array_equal(np.asarray(vflags_s), np.asarray(vflags_u))
    np.testing.assert_array_equal(np.asarray(flags_s), np.asarray(flags_u))


def test_sharded_e2e_drops_stale_segments(rng):
    """A cfar_segments table that does not tile the actual range extent must
    be dropped (whole-width CFAR), exactly like make_sharded_pipeline —
    review finding r2: stale bounds otherwise admit wrapped halo data into
    edge reference windows."""
    import dataclasses

    from radar_signal_process_tpu.ops.cfar import cascaded_cfar2d
    from radar_signal_process_tpu.ops.dbf import apply_dbf
    from radar_signal_process_tpu.parallel.sharding import make_sharded_e2e

    mesh3 = make_mesh(("dp", "sp", "tp"), shape=(2, 2, 2))
    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 400)),  # stale: ends at 400
        n_channels=4, n_beams=4,
    )
    iq = (
        rng.standard_normal((2, 32, 344, 4))
        + 1j * rng.standard_normal((2, 32, 344, 4))
    )
    coeffs = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    cfg = CFARConfig(ref_cells=3, guard_cells=4, threshold=5.0)

    run = make_sharded_e2e(prof, mesh3, coeffs, cfg, n_clutter=4)
    x = jax.device_put(
        jnp.asarray(iq), NamedSharding(mesh3, P("dp", "sp", None, "tp"))
    )
    _, flags_s, _ = run(x)

    echo = jnp.moveaxis(apply_dbf(jnp.asarray(iq), jnp.asarray(coeffs)), -1, 1)
    rdm_u = mtd_produce(echo, prof)
    flags_u, _ = cascaded_cfar2d(rdm_u, cfg, 4)   # whole-width, no segments
    np.testing.assert_array_equal(np.asarray(flags_s), np.asarray(flags_u))


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_pipeline_parallel_matches_unsharded(rng, depth):
    """GPipe-style stage pipeline == unsharded chain, bit-exact, all depths
    (depth 4 splits the CFAR cascade at its flag-plane materialization)."""
    import dataclasses

    from radar_signal_process_tpu.parallel.sharding import make_pipeline_parallel

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
    )
    cfg = CFARConfig(threshold=5.0)
    mesh = make_mesh(("pp",), shape=(depth,), devices=jax.devices()[:depth])
    run = make_pipeline_parallel(prof, mesh, cfg, n_clutter=4)

    echo = (rng.standard_normal((5, 64, prof.point_prt))
            + 1j * rng.standard_normal((5, 64, prof.point_prt))
            ).astype(np.complex64)
    rdm_pp, flags_pp = run(jnp.asarray(echo))

    rdm_u = mtd_produce(jnp.asarray(echo), prof)
    flags_u, _ = segmented_cfar(rdm_u, prof.cfar_segments, cfg, 4)
    np.testing.assert_array_equal(np.asarray(rdm_pp), np.asarray(rdm_u))
    np.testing.assert_array_equal(np.asarray(flags_pp), np.asarray(flags_u))


def test_expert_parallel_beam_calibration_matches_unsharded(rng):
    """MoE-routed per-beam calibration experts == per-frame gather + compress."""
    import dataclasses

    from radar_signal_process_tpu.ops.pulse_compression import (
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu.ops.waveforms import reference_pulses
    from radar_signal_process_tpu.parallel.sharding import make_expert_parallel

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=16, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
    )
    n_ep, n_beams = 4, 8
    mesh = make_mesh(("ep",), shape=(n_ep,), devices=jax.devices()[:n_ep])
    cal = (0.5 + rng.random((n_beams, prof.point_prt))).astype(np.float32)

    n_frames = 16  # 4 per device; beams balanced so nothing drops
    frames = (rng.standard_normal((n_frames, 16, prof.point_prt))
              + 1j * rng.standard_normal((n_frames, 16, prof.point_prt))
              ).astype(np.complex64)
    beam_ids = np.arange(n_frames, dtype=np.int32) % n_beams

    run = make_expert_parallel(prof, mesh, cal)
    got = run(jnp.asarray(frames), jnp.asarray(beam_ids))

    pulses = reference_pulses(prof)
    want = segmented_pulse_compression(
        jnp.asarray(frames * cal[beam_ids][:, None, :]), prof, pulses
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_expert_parallel_capacity_drops_to_zero(rng):
    """Frames beyond a destination bucket's capacity drop (zero output),
    matching MoE token-drop semantics; routed frames are unaffected."""
    import dataclasses

    from radar_signal_process_tpu.ops.pulse_compression import (
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu.ops.waveforms import reference_pulses
    from radar_signal_process_tpu.parallel.sharding import make_expert_parallel

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=8, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
    )
    n_ep, n_beams = 2, 4
    mesh = make_mesh(("ep",), shape=(n_ep,), devices=jax.devices()[:n_ep])
    cal = (0.5 + rng.random((n_beams, prof.point_prt))).astype(np.float32)

    # every frame on device 0 targets expert device 1's beams -> with
    # capacity=1 only the first such frame per source routes, rest drop
    n_frames = 8  # 4 per device
    frames = (rng.standard_normal((n_frames, 8, prof.point_prt))
              + 1j * rng.standard_normal((n_frames, 8, prof.point_prt))
              ).astype(np.complex64)
    beam_ids = np.full(n_frames, 2, dtype=np.int32)  # all -> expert dev 1

    run = make_expert_parallel(prof, mesh, cal, capacity=1)
    got = np.asarray(run(jnp.asarray(frames), jnp.asarray(beam_ids)))

    pulses = reference_pulses(prof)
    want = np.asarray(segmented_pulse_compression(
        jnp.asarray(frames * cal[beam_ids][:, None, :]), prof, pulses
    ))
    # frame 0 of each source shard (locals 0 and 4) routed; the rest dropped
    for f in range(n_frames):
        if f in (0, 4):
            np.testing.assert_array_equal(got[f], want[f])
        else:
            assert not got[f].any(), f"frame {f} should have been dropped"


def test_sharded_pipeline_renotch_no_phantom_edge_flags(rng, mesh):
    """R3 regression: wrapped global-edge halo columns must never become
    cascade winners.  With the wide re-notch, notched all-zero rows
    self-flag (0 >= 0) in the wrapped halo too, and an unmasked phantom
    winner there scatters marks onto real edge columns (seen as 13 extra
    column-0 flags in the two-process run)."""
    import dataclasses

    from radar_signal_process_tpu.models.detect import detect_rdm
    from radar_signal_process_tpu.models.mtd_pipeline import mtd_produce
    from radar_signal_process_tpu.parallel.sharding import make_sharded_pipeline

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)), n_beams=2,
    )
    cfg = CFARConfig(threshold=5.0)
    echo = (rng.standard_normal((2, 32, 344))
            + 1j * rng.standard_normal((2, 32, 344))).astype(np.complex64)

    rdm_u = mtd_produce(jnp.asarray(echo), prof)
    flags_u, _ = detect_rdm(rdm_u, prof, 4, cfg=cfg)

    run = make_sharded_pipeline(prof, mesh, cfg, n_clutter=4,
                                renotch_divisor=20)
    x = jax.device_put(jnp.asarray(echo), NamedSharding(mesh, P("dp")))
    _, flags_s, _ = run(x)
    np.testing.assert_array_equal(np.asarray(flags_s), np.asarray(flags_u))


def test_sharded_stream_matches_host_stream(rng, mesh):
    """Mesh streaming step (on-device PC reuse, VERDICT r4 item 3): three
    consecutive windows over four frames, bit-identical RDMs to the host
    streaming chain and flags to the split detector."""
    from radar_signal_process_tpu.models.host_parallel import (
        make_cpu_flags,
        make_cpu_stream_processor,
    )
    from radar_signal_process_tpu.parallel.sharding import make_sharded_stream

    import dataclasses

    n_prt = 64
    # the host chain sizes its windows from profile.prt_per_frame
    prof = dataclasses.replace(G2_PROFILE, prt_per_frame=n_prt)
    n_beams, n_pts = 2, prof.point_prt
    cfg = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0)
    n_clutter = 6
    frames = [
        (rng.standard_normal((n_beams, n_prt, n_pts))
         + 1j * rng.standard_normal((n_beams, n_prt, n_pts)))
        for _ in range(4)
    ]

    init, step = make_sharded_stream(
        prof, mesh, cfg, n_clutter, win_size=4, renotch_divisor=20
    )
    sh = NamedSharding(mesh, P("dp", "sp", None))
    pc = init(jax.device_put(jnp.asarray(frames[0]), sh))

    host = make_cpu_stream_processor(prof, win_size=4)
    flags_fn = make_cpu_flags(prof, n_clutter, cfg=cfg, renotch_divisor=20)

    for w in range(3):
        pc, rdm_s, flags_s, vflags_s = step(
            pc, jax.device_put(jnp.asarray(frames[w + 1]), sh)
        )
        want_rdm = host(frames[w], frames[w + 1], frame_idx=w)
        # FFT executables of different shard shapes differ at roundoff
        # (same bound as test_sharded_pipeline_matches_unsharded)
        np.testing.assert_allclose(np.asarray(rdm_s), want_rdm,
                                   rtol=1e-9, atol=1e-9)
        want_flags, want_vflags = flags_fn(want_rdm)
        np.testing.assert_array_equal(np.asarray(vflags_s), want_vflags)
        np.testing.assert_array_equal(np.asarray(flags_s), want_flags)


@pytest.mark.parametrize("depth", [2, 4])
def test_pipeline_parallel_g0_geometry(rng, depth):
    """The pipeline ring supports the G0 profile class (zero-padded
    unshifted Doppler FFT, VERDICT r4 item 9): bit-equal to the unsharded
    mtd_produce + whole-width cascade."""
    import dataclasses

    from radar_signal_process_tpu.config import G0_PROFILE, MTDConfig
    from radar_signal_process_tpu.ops.cfar import segmented_cfar
    from radar_signal_process_tpu.parallel.sharding import make_pipeline_parallel

    prof = dataclasses.replace(
        G0_PROFILE, prt_per_frame=48, point_prt=160,
        segment_points=(32, 128),
        mtd=MTDConfig(window="hamming", notch_divisor=0, fft_length=64,
                      fftshift=False),
    )
    cfg = CFARConfig(threshold=5.0)
    mesh = make_mesh(("pp",), shape=(depth,), devices=jax.devices()[:depth])
    run = make_pipeline_parallel(prof, mesh, cfg, n_clutter=3)

    echo = (rng.standard_normal((5, 48, prof.point_prt))
            + 1j * rng.standard_normal((5, 48, prof.point_prt))
            ).astype(np.complex64)
    rdm_pp, flags_pp = run(jnp.asarray(echo))
    assert rdm_pp.shape == (5, 64, prof.point_prt)

    rdm_u = mtd_produce(jnp.asarray(echo), prof)
    flags_u, _ = segmented_cfar(rdm_u, ((0, prof.point_prt),), cfg, 3)
    np.testing.assert_array_equal(np.asarray(rdm_pp), np.asarray(rdm_u))
    np.testing.assert_array_equal(np.asarray(flags_pp), np.asarray(flags_u))


def test_pipeline_parallel_mti_profile(rng):
    """mtd.mti_lag (previously fail-loud) threads through the ring."""
    import dataclasses

    from radar_signal_process_tpu.config import MTDConfig
    from radar_signal_process_tpu.ops.cfar import segmented_cfar
    from radar_signal_process_tpu.parallel.sharding import make_pipeline_parallel

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
        mtd=MTDConfig(window="kaiser", window_beta=8.0, notch_divisor=150,
                      fftshift=True, mti_lag=5),
    )
    cfg = CFARConfig(threshold=5.0)
    mesh = make_mesh(("pp",), shape=(3,), devices=jax.devices()[:3])
    run = make_pipeline_parallel(prof, mesh, cfg, n_clutter=4)

    echo = (rng.standard_normal((4, 32, prof.point_prt))
            + 1j * rng.standard_normal((4, 32, prof.point_prt))
            ).astype(np.complex64)
    rdm_pp, flags_pp = run(jnp.asarray(echo))
    rdm_u = mtd_produce(jnp.asarray(echo), prof)
    flags_u, _ = segmented_cfar(rdm_u, prof.cfar_segments, cfg, 4)
    np.testing.assert_array_equal(np.asarray(rdm_pp), np.asarray(rdm_u))
    np.testing.assert_array_equal(np.asarray(flags_pp), np.asarray(flags_u))


def test_sharded_stream_istc_and_measured_pulses(rng, mesh):
    """The mesh stream's iSTC + measured-pulse hooks match the host chain."""
    import dataclasses

    from radar_signal_process_tpu.config import MTDConfig
    from radar_signal_process_tpu.models.host_parallel import (
        make_cpu_stream_processor,
    )
    from radar_signal_process_tpu.ops.waveforms import pulses_with_overrides
    from radar_signal_process_tpu.parallel.sharding import make_sharded_stream

    n_prt = 32
    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=n_prt, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
        mtd=MTDConfig(window="kaiser", window_beta=8.0, notch_divisor=150,
                      fftshift=True, istc=True),
    )
    stc = np.linspace(0.0, 6.0, 100)
    wf = np.exp(1j * np.pi * np.linspace(-1, 1, 40) ** 2) * 1.1
    pulses = pulses_with_overrides(prof, {1: wf})
    frames = [
        (rng.standard_normal((2, n_prt, 344))
         + 1j * rng.standard_normal((2, n_prt, 344)))
        for _ in range(3)
    ]

    init, step = make_sharded_stream(
        prof, mesh, CFARConfig(threshold=5.0), 4, win_size=4,
        renotch_divisor=20, stc_curve_db=stc, pulses=pulses,
    )
    sh = NamedSharding(mesh, P("dp", "sp", None))
    pc = init(jax.device_put(jnp.asarray(frames[0]), sh))
    host = make_cpu_stream_processor(prof, 4, stc_curve_db=stc, pulses=pulses)
    for w in range(2):
        pc, rdm_s, _, _ = step(pc, jax.device_put(jnp.asarray(frames[w + 1]), sh))
        want = host(frames[w], frames[w + 1], frame_idx=w)
        np.testing.assert_allclose(np.asarray(rdm_s), want, rtol=1e-9,
                                   atol=1e-9)
