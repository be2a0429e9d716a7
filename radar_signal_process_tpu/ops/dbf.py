"""Digital beamforming: channel -> beam projection as one matrix product.

The reference forms 13 beams from 16 channels with a per-PRT complex matmul
``(3404 x 16) * DBF_coeffs.'`` (``FrameDataRead_xzr.m:150-159``, coefficient
load at ``bin_to_mat_xzr.m:22-29``).  Here the whole frame is beamformed with
one einsum ``(..., samples, channels) x (beams, channels) -> (..., samples,
beams)`` — a single large complex matmul.  It runs at ``HIGHEST``
precision: on a GPU a float32 product may otherwise run in TF32 (about three
decimal digits), and the product is memory-bound, so full precision costs
little.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def apply_dbf(iq: jnp.ndarray, coeffs: jnp.ndarray | np.ndarray) -> jnp.ndarray:
    """Beamform ``iq`` (..., n_samples, n_channels) with ``coeffs``
    (n_beams, n_channels); non-conjugating, matching the reference's ``.'``
    transpose.  Returns (..., n_samples, n_beams)."""
    coeffs = jnp.asarray(coeffs)
    return jnp.einsum("...sc,bc->...sb", iq, coeffs,
                      precision=jax.lax.Precision.HIGHEST)


def load_dbf_coeffs(path: str, n_channels: int | None = None) -> np.ndarray:
    """Load DBF coefficients from the interleaved-I/Q text format.

    One row per beam; columns alternate I, Q per channel
    (``bin_to_mat_xzr.m:22-29``).  Returns complex128 (n_beams, n_channels).
    """
    raw = np.loadtxt(path, delimiter=None, dtype=np.float64, ndmin=2)
    if raw.shape[1] % 2 != 0:
        raise ValueError(f"expected an even number of columns, got {raw.shape[1]}")
    coeffs = raw[:, 0::2] + 1j * raw[:, 1::2]
    if n_channels is not None and coeffs.shape[1] != n_channels:
        raise ValueError(
            f"coefficient file has {coeffs.shape[1]} channels, expected {n_channels}"
        )
    return coeffs
