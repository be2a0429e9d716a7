"""Streaming pipeline test: capture -> overlapped ingest/compute -> detections."""

import dataclasses

import numpy as np

from radar_signal_process_tpu.config import G2_PROFILE
from radar_signal_process_tpu.ingest import G2FrameReader
from radar_signal_process_tpu.models.streaming import StreamingPipeline
from radar_signal_process_tpu.sim.packets_synth import write_g2_capture

SMALL = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=128, segment_points=(24, 40, 64),
    n_channels=2, n_beams=2,
)


def test_streaming_pipeline(tmp_path, rng):
    n_frames = 4
    shape = (n_frames, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-500, 500, shape) + 1j * rng.integers(-500, 500, shape)).astype(
        np.complex128
    )
    # a strong pulse at a fixed cell in every PRT -> stationary target
    iq[:, :, 40, :] += 20000.0
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)

    pipe = StreamingPipeline(
        G2FrameReader(str(tmp_path), SMALL),
        SMALL,
        win_size=2,
        max_frames=n_frames,
        clutter_v=1e-6,  # tiny clutter region for the small geometry
        max_detections=8,
    )
    results = list(pipe)
    # n_frames frames -> n_frames-1 consecutive pairs
    assert [r.frame_idx for r in results] == [0, 1, 2]
    for r in results:
        assert r.rdms.shape == (2, 2, 16, 128)
    assert pipe.counters.get("frames_ingested") == n_frames
    assert pipe.counters.get("windows_processed") == n_frames - 1


def test_multi_target_scene_detected(rng):
    """Two targets at distinct (V, R) both detected through the full chain."""
    import jax.numpy as jnp

    from radar_signal_process_tpu.config import CFARConfig
    from radar_signal_process_tpu.models.detect import detect_rdm
    from radar_signal_process_tpu.models.mtd_pipeline import mtd_produce
    from radar_signal_process_tpu.ops import extract_detections
    from radar_signal_process_tpu.sim import apply_scr, synthetic_clutter
    from radar_signal_process_tpu.sim.targets import synthesize_scene
    from radar_signal_process_tpu.config import G2_PROFILE as prof

    scene = synthesize_scene(prof, [(-5.7, 320.0, 1.0), (11.0, 900.0, 1.0)])
    clutter = synthetic_clutter(prof, seed=11)
    echo = apply_scr(scene, clutter, 20.0, prof) + clutter
    rdm = mtd_produce(jnp.asarray(echo), prof)
    flags, _ = detect_rdm(rdm, prof, 14, cfg=CFARConfig(threshold=5.0))
    dets = extract_detections(flags, rdm, 32)
    valid = np.asarray(dets.valid)
    cols = set(int(c) for c in np.asarray(dets.r_idx)[valid])
    col1 = 951 + round(320.0 / prof.delta_r)
    col2 = 951 + round(900.0 / prof.delta_r)
    assert any(abs(c - col1) <= 1 for c in cols), (cols, col1)
    assert any(abs(c - col2) <= 1 for c in cols), (cols, col2)


def test_streaming_stops_cleanly_on_truncated_capture(tmp_path, rng):
    """A capture truncated mid-frame ends the stream without raising."""
    n_frames = 3
    shape = (n_frames, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-500, 500, shape) + 1j * rng.integers(-500, 500, shape)).astype(
        np.complex128
    )
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)
    import os

    p = tmp_path / "1.000001.bin"
    blob = p.read_bytes()
    p.write_bytes(blob[: len(blob) * 3 // 4])  # chop inside frame 3

    pipe = StreamingPipeline(
        G2FrameReader(str(tmp_path), SMALL), SMALL, win_size=2,
        max_frames=10, clutter_v=1e-6, max_detections=4,
    )
    results = list(pipe)
    assert [r.frame_idx for r in results] == [0]  # frames 0,1 complete -> 1 pair


def test_streaming_with_device_dbf(tmp_path, rng):
    """Raw DDC channels beamformed on device inside the streaming producer."""
    n_frames = 3
    shape = (n_frames, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-500, 500, shape) + 1j * rng.integers(-500, 500, shape)).astype(
        np.complex128
    )
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)
    coeffs = (rng.standard_normal((SMALL.n_beams, SMALL.n_channels))
              + 1j * rng.standard_normal((SMALL.n_beams, SMALL.n_channels)))
    pipe = StreamingPipeline(
        G2FrameReader(str(tmp_path), SMALL), SMALL, win_size=2,
        max_frames=n_frames, clutter_v=1e-6, max_detections=4,
        dbf_coeffs=coeffs,
    )
    results = list(pipe)
    assert [r.frame_idx for r in results] == [0, 1]
    assert results[0].rdms.shape == (SMALL.n_beams, 2, 16, 128)


def test_streaming_all_beam_detection(tmp_path, rng):
    """Detection runs over the FULL (beam, slice) stack (main_cfar.m:85-96):
    a target present only in beam 1 is found in every window slice there,
    not just at (beam 0, slice 0)."""
    n_frames = 3
    n, pts = SMALL.prt_per_frame, SMALL.point_prt
    shape = (n_frames, n, pts, SMALL.n_channels)
    iq = (rng.integers(-200, 200, shape) + 1j * rng.integers(-200, 200, shape)).astype(
        np.complex128
    )
    # moving target ONLY in channel/beam 1: Doppler ~prf/4, range cell 100,
    # phase continuous across frames so the doubled-CPI window stays coherent
    m = np.arange(n_frames * n).reshape(n_frames, n)
    iq[:, :, 100, 1] += 30000.0 * np.exp(1j * 2 * np.pi * 0.25 * m)
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)

    pipe = StreamingPipeline(
        G2FrameReader(str(tmp_path), SMALL), SMALL, win_size=2,
        max_frames=n_frames, clutter_v=1e-6, max_detections=8,
    )
    results = list(pipe)
    assert [r.frame_idx for r in results] == [0, 1]
    r0 = results[0]
    assert r0.flags.shape == (SMALL.n_beams, 2, n, pts)
    valid = np.asarray(r0.detections.valid)       # (beam, slice, K)
    assert valid.shape[:2] == (SMALL.n_beams, 2)
    # beam 1 detects in EVERY slice, including slice != 0
    assert valid[1].any(axis=-1).all(), valid.sum(axis=-1)
    # the target beam dominates the noise-only beam
    flags = np.asarray(r0.flags)
    assert flags[1].sum() > flags[0].sum()
    # and the per-frame hit counter saw them
    assert pipe.counters.get("cfar_hits") == sum(
        int(np.asarray(r.flags).sum()) for r in results
    )


def test_streaming_block_boundaries(tmp_path, rng):
    """Multiple pipelined blocks: windows stay consecutive across the
    block-carry boundary and match the single-block run."""
    import dataclasses

    from radar_signal_process_tpu.config import G2_PROFILE, PROFILES
    from radar_signal_process_tpu.ingest import G2FrameReader
    from radar_signal_process_tpu.models.streaming import StreamingPipeline
    from radar_signal_process_tpu.sim.packets_synth import write_g2_capture

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
        n_channels=2, n_beams=2,
    )
    n_frames = 6
    shape = (n_frames, prof.prt_per_frame, prof.point_prt, prof.n_channels)
    iq = (rng.integers(-1500, 1500, size=shape).astype(np.float32)
          + 1j * rng.integers(-1500, 1500, size=shape).astype(np.float32))
    cap = str(tmp_path / "cap")
    write_g2_capture(cap, iq, prof, data_type=1)

    def run(block_windows):
        pipe = StreamingPipeline(
            G2FrameReader(cap, prof), prof, win_size=2, max_frames=n_frames,
            block_windows=block_windows,
        )
        out = [(r.frame_idx, int(np.asarray(r.flags).sum())) for r in pipe]
        return out

    small = run(2)   # blocks of 2 windows -> 3 blocks with carry
    big = run(10)    # single block
    assert [w for w, _ in small] == list(range(n_frames - 1))
    assert small == big


def test_streaming_pipelined_gap_and_validation(tmp_path, rng):
    """A non-consecutive frame closes the current block (its windows still
    process, like the windowed iterator's skip-the-gap), and block_windows
    < 1 fails loud instead of hanging."""
    import dataclasses

    import pytest

    from radar_signal_process_tpu.config import G2_PROFILE
    from radar_signal_process_tpu.models.streaming import StreamingPipeline

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=16, point_prt=344,
        segment_points=(24, 80, 240),
        cfar_segments=((0, 24), (24, 104), (104, 344)),
        n_channels=2, n_beams=2,
    )

    class _NoReader:
        def read_frame(self, idx):
            raise AssertionError("producer is monkeypatched")

    with pytest.raises(ValueError, match="block_windows"):
        StreamingPipeline(_NoReader(), prof, block_windows=0)

    pipe = StreamingPipeline(_NoReader(), prof, win_size=2, max_frames=100)
    shape = (prof.n_beams, prof.prt_per_frame, prof.point_prt)

    def frame():
        import jax.numpy as jnp

        return jnp.asarray(
            (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        )

    seq = [(0, frame()), (1, frame()), (2, frame()),
           (5, frame()), (6, frame())]

    def fake_produce():
        for idx, f in seq:
            pipe._queue.put((idx, f))

    pipe._produce_inner = fake_produce
    windows = [r.frame_idx for r in pipe]
    assert windows == [0, 1, 5]


def test_streaming_emission_modes(tmp_path, rng):
    """StreamingPipeline emit modes: detections/hits identical to full;
    the dropped stacks come back as None (VERDICT r5 item 1)."""
    n_frames = 4
    shape = (n_frames, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-500, 500, shape)
          + 1j * rng.integers(-500, 500, shape)).astype(np.complex128)
    iq[:, :, 40, :] += 20000.0
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)

    def run(emit):
        pipe = StreamingPipeline(
            G2FrameReader(str(tmp_path), SMALL), SMALL, win_size=2,
            max_frames=n_frames, clutter_v=1e-6, max_detections=8, emit=emit,
        )
        return list(pipe), pipe.counters.snapshot()

    full, c_full = run("full")
    assert all(r.cfar_hits == int(np.asarray(r.flags).sum()) for r in full)
    for emit in ("flags", "detections"):
        got, c_got = run(emit)
        assert [r.frame_idx for r in got] == [r.frame_idx for r in full]
        for g, f in zip(got, full):
            assert g.rdms is None
            if emit == "detections":
                assert g.flags is None
            else:
                np.testing.assert_array_equal(g.flags, f.flags)
            assert g.cfar_hits == f.cfar_hits
            np.testing.assert_array_equal(
                np.asarray(g.detections.valid), np.asarray(f.detections.valid)
            )
            np.testing.assert_array_equal(
                np.asarray(g.detections.amplitude),
                np.asarray(f.detections.amplitude),
            )
        assert c_got["cfar_hits"] == c_full["cfar_hits"]

    import pytest

    with pytest.raises(ValueError, match="emit"):
        StreamingPipeline(G2FrameReader(str(tmp_path), SMALL), SMALL,
                          emit="rdm")


def test_streaming_soak_long_capture(tmp_path, rng):
    """Soak (VERDICT r5 item 6): 50 consecutive windows through >=8
    pipelined blocks — in-order emission, bounded live window buffers
    (no leak across blocks), and consistent counters."""
    import weakref

    from radar_signal_process_tpu.models import host_parallel as hp

    n_frames = 51
    block_windows = 6            # -> ceil(50/6) = 9 blocks
    shape = (n_frames, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-300, 300, shape)
          + 1j * rng.integers(-300, 300, shape)).astype(np.complex64)
    iq[:, :, 40, :] += 15000.0
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)

    allocs, live, peak = [0], [0], [0]
    lock = __import__("threading").Lock()
    orig = hp._alloc_detect_buffers

    def counting_alloc(*a, **kw):
        buf = orig(*a, **kw)
        with lock:
            allocs[0] += 1
            live[0] += 1
            peak[0] = max(peak[0], live[0])

        def dead():
            with lock:
                live[0] -= 1

        weakref.finalize(buf["det_valid"], dead)
        return buf

    hp._alloc_detect_buffers = counting_alloc
    try:
        pipe = StreamingPipeline(
            G2FrameReader(str(tmp_path), SMALL), SMALL, win_size=2,
            max_frames=n_frames, clutter_v=1e-6, max_detections=8,
            block_windows=block_windows,
        )
        seen = []
        hits_sum = 0
        for r in pipe:
            seen.append(r.frame_idx)
            hits_sum += r.cfar_hits
            assert r.rdms.shape == (SMALL.n_beams, 2, SMALL.prt_per_frame,
                                    SMALL.point_prt)
    finally:
        hp._alloc_detect_buffers = orig

    assert seen == list(range(n_frames - 1))          # in-order emission
    assert allocs[0] == n_frames - 1                  # one buffer per window
    # live buffers bounded by the block span (+ the in-flight handoff),
    # never the whole 50-window capture
    assert peak[0] <= block_windows + 3, peak[0]
    assert live[0] <= 2, live[0]                      # drained at the end
    snap = pipe.counters.snapshot()
    assert snap["frames_ingested"] == n_frames
    assert snap["windows_processed"] == n_frames - 1
    assert snap["cfar_hits"] == hits_sum


def test_streaming_windowed_path_emission_modes(tmp_path, rng):
    """The windowed iterator (GPU/mesh-style path, use_host_parallel=False)
    honors the emission modes at the yield boundary."""
    n_frames = 3
    shape = (n_frames, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-500, 500, shape)
          + 1j * rng.integers(-500, 500, shape)).astype(np.complex128)
    iq[:, :, 40, :] += 20000.0
    write_g2_capture(str(tmp_path), iq, SMALL, data_type=1)

    def run(emit):
        pipe = StreamingPipeline(
            G2FrameReader(str(tmp_path), SMALL), SMALL, win_size=2,
            max_frames=n_frames, clutter_v=1e-6, max_detections=8,
            use_host_parallel=False, emit=emit,
        )
        return list(pipe)

    full = run("full")
    det = run("detections")
    assert [r.frame_idx for r in det] == [r.frame_idx for r in full]
    for g, f in zip(det, full):
        assert g.rdms is None and g.flags is None
        assert g.cfar_hits == f.cfar_hits == int(np.asarray(f.flags).sum())
        np.testing.assert_array_equal(
            np.asarray(g.detections.valid), np.asarray(f.detections.valid)
        )


def test_mesh_stream_warns_below_parity_floor(rng, caplog):
    """Toy geometries below the CFAR parity floor (cropped velocity extent
    <= 2*(ref+guard)) warn loudly: the roll-form (sharded) and padded-form
    (host) edge fallbacks legitimately diverge there (ops/cfar.py)."""
    import logging

    import jax

    from radar_signal_process_tpu.parallel import make_mesh

    prof = dataclasses.replace(SMALL, cfar_segments=())
    mesh = make_mesh(("dp", "sp"), shape=(2, 4), devices=jax.devices())
    with caplog.at_level(logging.WARNING, logger="radar_tpu.streaming"):
        StreamingPipeline(None, prof, win_size=2, mesh=mesh, clutter_v=3.0)
    assert any("parity floor" in r.message for r in caplog.records)
    # real geometry: no warning
    caplog.clear()
    from radar_signal_process_tpu.config import G2_PROFILE
    with caplog.at_level(logging.WARNING, logger="radar_tpu.streaming"):
        StreamingPipeline(None, G2_PROFILE, win_size=2, mesh=mesh)
    assert not any("parity floor" in r.message for r in caplog.records)
