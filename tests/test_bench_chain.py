"""Bench self-consistency: the CPU threaded chain == the batched chain.

The headline number must time the same computation the batched (device-path)
chain performs; both reduce to (sum(rdms), sum(flags)) per frame.
"""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

import bench
from radar_signal_process_tpu.config import G2_PROFILE

TINY = dataclasses.replace(
    G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_beams=3,
)


def test_threaded_chain_matches_batched(rng):
    prof, threaded = bench.build_chain(beam_mapped=True, profile=TINY, n_clutter=4)
    _, batched = bench.build_chain(beam_mapped=False, profile=TINY, n_clutter=4)
    shape = (TINY.n_beams, 2 * TINY.prt_per_frame, TINY.point_prt)
    x = jnp.asarray(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
            np.complex64
        )
    )
    got = np.sum(np.asarray(jax.block_until_ready(threaded(x))), axis=0)
    want = np.asarray(jax.block_until_ready(batched(x)))
    # flag counts are integral and must agree exactly; the RDM sum differs
    # only by f32 accumulation order across chunks
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def test_stream_chain_matches_batched(rng):
    """The streaming chain (per-frame PC reuse + cross-frame pipelined
    queue) computes bit-identical window flags to the batched chain."""
    prof, stream = bench.build_stream_chain(profile=TINY, n_clutter=4)
    _, batched = bench.build_chain(beam_mapped=False, profile=TINY, n_clutter=4)
    shape = (TINY.n_beams, TINY.prt_per_frame, TINY.point_prt)
    n_windows = 3
    frames = [
        jnp.asarray(
            (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
                np.complex64
            )
        )
        for _ in range(n_windows + 1)
    ]
    got = np.sum(
        np.asarray(jax.block_until_ready(stream(frames))), axis=0
    )
    want = np.zeros(2)
    for w in range(n_windows):
        win = jnp.concatenate([frames[w], frames[w + 1]], axis=-2)
        want += np.asarray(jax.block_until_ready(batched(win)))
    # flag counts are integral and must agree exactly across all windows
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def test_stream_chain_matches_batched_g1_geometry(rng):
    """Stream-vs-batched parity on a G1-style profile (different segment
    split, wide-notch divisor) — the cross-boundary CPI assembly must hold
    for every profile geometry, not just the G2-like one."""
    from radar_signal_process_tpu.config import G1_PROFILE

    # geometry respects the documented CFAR floor (every segment and the
    # clutter-cropped velocity extent > 2*(ref+guard) = 24; see ops/cfar.py
    # — below it, cells with BOTH reference windows invalid legitimately
    # diverge between the roll and padded-slice forms)
    tg1 = dataclasses.replace(
        G1_PROFILE, prt_per_frame=32, point_prt=300,
        segment_points=(30, 110, 160),
        cfar_segments=((0, 30), (30, 140), (140, 300)), n_beams=2,
    )
    prof, stream = bench.build_stream_chain(profile=tg1, n_clutter=3)
    _, batched = bench.build_chain(beam_mapped=False, profile=tg1, n_clutter=3)
    shape = (tg1.n_beams, tg1.prt_per_frame, tg1.point_prt)
    frames = [
        jnp.asarray(
            (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
                np.complex64
            )
        )
        for _ in range(3)
    ]
    got = np.sum(np.asarray(jax.block_until_ready(stream(frames))), axis=0)
    want = np.zeros(2)
    for w in range(2):
        win = jnp.concatenate([frames[w], frames[w + 1]], axis=-2)
        want += np.asarray(jax.block_until_ready(batched(win)))
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
