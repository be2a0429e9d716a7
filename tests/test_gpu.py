"""Numerics on the card (marker ``gpu``): float32/complex64 against float64.

The ``gpu`` fixture skips these where JAX has no GPU.  On the card:

    RSP_TEST_DEVICE=gpu python -m pytest -m gpu tests/test_gpu.py

(``chip_smoke.py`` runs them as its last phase.)  Tolerances: a float32
product or FFT of these sizes keeps about 1e-6 of the peak; TF32 keeps about
1e-3, so a bound of 1e-5 tells the two apart.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radar_signal_process_tpu.config import CFARConfig, G2_PROFILE, NARROW_PULSE_FIR_TAPS
from radar_signal_process_tpu.ops.cfar import cascaded_cfar2d
from radar_signal_process_tpu.ops.dbf import apply_dbf
from radar_signal_process_tpu.ops.measure import spline_interp_notaknot
from radar_signal_process_tpu.ops.mtd import doppler_process
from radar_signal_process_tpu.ops.pulse_compression import segmented_pulse_compression
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu.ops.windows import make_window
from tests.oracle import cfar as oracle_cfar
from tests.oracle import dsp as oracle_dsp

pytestmark = pytest.mark.gpu

BOUND = 1e-5


def _crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)))


def test_arrays_live_on_the_gpu(gpu):
    x = jnp.arange(8.0)
    assert x.devices() == {gpu}
    assert x.dtype == jnp.float32          # no x64 on the card


def test_dbf_runs_at_full_precision(gpu, rng):
    iq = _crandn(rng, (664, 16)).astype(np.complex64)
    coeffs = _crandn(rng, (13, 16)).astype(np.complex64)
    got = apply_dbf(jnp.asarray(iq), coeffs)
    want = iq.astype(np.complex128) @ coeffs.astype(np.complex128).T
    assert _rel_err(got, want) < BOUND


def test_spline_upsampling_runs_at_full_precision(gpu, rng):
    y = rng.standard_normal((256, 5)).astype(np.float32)
    from radar_signal_process_tpu.ops.measure import spline_eval_matrix

    got = spline_interp_notaknot(jnp.asarray(y), 8)
    want = y.astype(np.float64) @ spline_eval_matrix(5, 8).T
    assert _rel_err(got, want) < BOUND


def test_doppler_fft_at_g2_cpi_length(gpu, rng):
    n = G2_PROFILE.prt_per_frame
    pc = _crandn(rng, (n, 512)).astype(np.complex64)
    w = make_window("kaiser", n, 8.0)
    got = doppler_process(jnp.asarray(pc), w)
    want = oracle_dsp.doppler_process(pc.astype(np.complex128), w)
    assert _rel_err(got, want) < BOUND


def test_pulse_compression_at_g2_width(gpu, rng):
    prof = G2_PROFILE
    echo = _crandn(rng, (8, prof.point_prt)).astype(np.complex64)
    pulses = reference_pulses(prof)
    got = segmented_pulse_compression(jnp.asarray(echo), prof, pulses)
    want = oracle_dsp.segmented_pulse_compression(
        echo.astype(np.complex128), prof.segment_points, pulses,
        np.asarray(NARROW_PULSE_FIR_TAPS, np.float64),
    )
    assert _rel_err(got, want) < BOUND


def test_cfar_cascade_equals_oracle(gpu, rng):
    # integer amplitudes: float32 reference sums are exact, and a cell can
    # never sit exactly on a non-integer mean, so the flags must be equal
    rdm = rng.integers(1, 9, size=(128, 200)).astype(np.float32)
    cfg = CFARConfig(ref_cells=5, guard_cells=2, threshold=1.0)
    flags, vflags = cascaded_cfar2d(jnp.asarray(rdm), cfg, 6)
    want_f, want_v = oracle_cfar.execute_cfar(
        rdm.astype(np.float64), 5, 2, 1.0, 0, 5, 2, 1.0, 0, 6, True
    )
    assert np.asarray(vflags).sum() > 0
    np.testing.assert_array_equal(np.asarray(vflags), want_v.astype(bool))
    np.testing.assert_array_equal(np.asarray(flags), want_f.astype(bool))
    assert jax.devices()[0] == gpu
