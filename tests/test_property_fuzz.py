"""Property fuzz: CFAR parity across random geometries; graft entry points."""

import numpy as np
import pytest

import jax.numpy as jnp

from radar_signal_process_tpu.config import CFARConfig
from radar_signal_process_tpu.ops.cfar import cascaded_cfar2d, cfar1d
from tests.oracle import cfar as oracle


def test_cfar1d_random_geometries(rng):
    """1-D CFAR flag parity over random (r, g, T, N, method) draws."""
    for _ in range(12):
        r = int(rng.integers(1, 8))
        g = int(rng.integers(0, 10))
        n = int(rng.integers(2 * (r + g) + 2, 200))
        t = float(rng.uniform(0.5, 10.0))
        method = int(rng.integers(0, 2))
        data = np.abs(rng.standard_normal((5, n))) + 0.05
        got = np.asarray(cfar1d(jnp.asarray(data), r, g, t, method))
        want = oracle.cfar1d_sub(data, r, g, t, method).astype(bool)
        np.testing.assert_array_equal(got, want, err_msg=f"r={r} g={g} n={n} t={t}")


def test_cascade_random_geometries(rng):
    for _ in range(6):
        r = int(rng.integers(2, 7))
        g = int(rng.integers(1, 9))
        nc = int(rng.integers(2, 12))
        nv = int(rng.integers(2 * nc + 2 * (r + g) + 8, 160))
        nr = int(rng.integers(2 * (r + g) + 6, 220))
        t = float(rng.uniform(2.0, 8.0))
        rdm = np.abs(rng.standard_normal((nv, nr))) + 0.2
        for _ in range(4):
            rdm[rng.integers(0, nv), rng.integers(0, nr)] += 30.0
        cfg = CFARConfig(ref_cells=r, guard_cells=g, threshold=t)
        got_f, got_v = cascaded_cfar2d(jnp.asarray(rdm), cfg, nc)
        want_f, want_v = oracle.execute_cfar(rdm, r, g, t, 0, r, g, t, 0, nc, True)
        np.testing.assert_array_equal(np.asarray(got_v), want_v.astype(bool))
        np.testing.assert_array_equal(np.asarray(got_f), want_f.astype(bool))


@pytest.mark.slow
def test_graft_entry_compiles():
    import jax

    import __graft_entry__ as graft

    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    rdms, flags = out
    assert rdms.shape == (13, 4, 332, 3404)
    assert flags.shape == rdms.shape


def test_split_cfar_random_geometries(rng):
    """Split flags|select (both layouts) == one-exec cascade on random draws."""
    from radar_signal_process_tpu.ops.cfar import (
        segmented_cfar,
        segmented_cfar_flags,
        segmented_cfar_select,
    )

    for _ in range(6):
        r = int(rng.integers(2, 7))
        g = int(rng.integers(1, 9))
        nc = int(rng.integers(2, 12))
        nv = int(rng.integers(2 * nc + 2 * (r + g) + 8, 160))
        w_min = 2 * (r + g) + 6
        w1 = int(rng.integers(w_min, w_min + 60))
        w2 = int(rng.integers(w_min, w_min + 80))
        segs = ((0, w1), (w1, w1 + w2))
        nr = w1 + w2
        t = float(rng.uniform(2.0, 8.0))
        ext = int(rng.integers(1, 3))
        rdm = np.abs(rng.standard_normal((nv, nr))) + 0.2
        for _ in range(4):
            rdm[rng.integers(0, nv), rng.integers(0, nr)] += 30.0
        cfg = CFARConfig(ref_cells=r, guard_cells=g, threshold=t,
                         range_extend_cells=ext)
        x = jnp.asarray(rdm.astype(np.float32))
        want_f, want_v = segmented_cfar(x, segs, cfg, nc)
        vf, rf = segmented_cfar_flags(x, segs, cfg, nc)
        got_f, got_v = segmented_cfar_select(x, vf, rf, segs, cfg, nc)
        msg = f"r={r} g={g} nc={nc} segs={segs} ext={ext}"
        np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f),
                                      err_msg=msg)
        np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v),
                                      err_msg=msg)
        # transposed layout
        vf_t, rf_t = segmented_cfar_flags(x.T, segs, cfg, nc, transposed=True)
        gf_t, gv_t = segmented_cfar_select(x.T, vf_t, rf_t, segs, cfg, nc,
                                           transposed=True)
        np.testing.assert_array_equal(np.asarray(gf_t).T, np.asarray(want_f),
                                      err_msg=msg + " (transposed)")
        np.testing.assert_array_equal(np.asarray(gv_t).T, np.asarray(want_v),
                                      err_msg=msg + " (transposed)")
