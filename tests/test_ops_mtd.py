"""Golden tests: MTD / clutter-suppression ops vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from radar_signal_process_tpu.ops import (
    doppler_process,
    istc_compensate,
    make_window,
    mti_cancel,
    zero_velocity_notch,
    zero_velocity_notch_unshifted,
)
from tests.oracle import dsp as oracle


def test_kaiser_window_matches_matlab_definition():
    # MATLAB kaiser(N, beta) is the symmetric Kaiser window == np.kaiser
    w = make_window("kaiser", 332, 8.0)
    assert w.shape == (332,)
    assert np.isclose(w[0], w[-1])
    assert np.argmax(w) in (165, 166)


def test_doppler_process_matches_oracle(rng):
    pc = rng.standard_normal((64, 40)) + 1j * rng.standard_normal((64, 40))
    w = make_window("kaiser", 64, 8.0)
    got = doppler_process(jnp.asarray(pc), w)
    want = oracle.doppler_process(pc, w)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_doppler_process_batched(rng):
    pc = rng.standard_normal((3, 64, 40)) + 1j * rng.standard_normal((3, 64, 40))
    w = make_window("kaiser", 64, 8.0)
    got = np.asarray(doppler_process(jnp.asarray(pc), w))
    for b in range(3):
        np.testing.assert_allclose(got[b], oracle.doppler_process(pc[b], w), rtol=1e-9)


@pytest.mark.parametrize("n,divisor", [(332, 150), (664, 150), (1536, 20), (155, 20)])
def test_zero_velocity_notch_matches_oracle(rng, n, divisor):
    rdm = np.abs(rng.standard_normal((n, 30)))
    got = zero_velocity_notch(jnp.asarray(rdm), divisor=divisor)
    want = oracle.zero_velocity_notch(rdm, divisor)
    np.testing.assert_allclose(np.asarray(got), want)


def test_zero_velocity_notch_unshifted():
    rdm = np.ones((2048, 10))
    out = np.asarray(zero_velocity_notch_unshifted(jnp.asarray(rdm), n_clutter=6))
    # DMX_SignalProcessing_main_xzr.m:463: rows 1..7 and 2043..2048 (1-based)
    assert (out[:7] == 0).all()
    assert (out[2042:] == 0).all()
    assert (out[7:2042] == 1).all()


def test_mti_cancel_matches_oracle(rng):
    echo = rng.standard_normal((100, 16)) + 1j * rng.standard_normal((100, 16))
    got = mti_cancel(jnp.asarray(echo), lag=30)
    want = oracle.mti_cancel(echo, lag=30)
    np.testing.assert_allclose(np.asarray(got), want)


def test_istc_compensate(rng):
    echo = rng.standard_normal((4, 100)) + 1j * rng.standard_normal((4, 100))
    stc = np.linspace(0.0, 20.0, 60)  # shorter than fast time: zero-padded
    got = np.asarray(istc_compensate(jnp.asarray(echo), stc))
    gain = np.concatenate([10 ** (stc / 20.0), np.ones(40)])
    np.testing.assert_allclose(got, echo * gain, rtol=1e-12)


