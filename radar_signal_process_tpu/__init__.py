"""radar_signal_process_tpu — a JAX pulse-Doppler radar signal-processing framework.

A JAX / XLA implementation of the capabilities of the
MATLAB reference ``XuZerui2023/Radar-Signal-Process`` (see ``SURVEY.md`` at the
repo root for the full component inventory and layer map of the reference).

Layer map (re-design of the reference's implicit layers):

* ``config``   — typed radar profiles (G0/G1/G2 hardware generations) with
  derived quantities (reference: per-script constants, e.g.
  ``MTD/main_produce_dataset_win_xzr_v2.m:22-44``).
* ``ops``      — pure jitted DSP kernels: pulse compression, MTD Doppler
  processing, clutter suppression, CA-CFAR, sub-bin parameter measurement
  (reference layer L2, ``SURVEY.md`` §1).
* ``models``   — per-generation pipeline orchestrators composing the ops into
  frame-level processing chains (reference layer L3/L4).
* ``ingest``   — cross-file byte-stream splicing + PRT packet parsing + DBF
  (reference layer L0/L1; C++ fast path with NumPy fallback).
* ``sim``      — synthetic LFM target injection at controlled SCR into
  measured/synthetic clutter (reference S1-S3).
* ``evalx``    — detection-quality metrics: false-alarm rate, detection rate,
  accuracy, localization PCF (reference S4, ``main_cfar.m:163-279``).
* ``parallel`` — mesh construction, data-parallel and range-sharded execution
  with halo exchange via ``shard_map``/``ppermute``.
* ``kernels``  — the CPU-only native C++ CFAR cascade.
* ``utils``    — structured logging, manifests (checkpoint/resume), profiling.
"""

__version__ = "0.1.0"

from radar_signal_process_tpu.config import (  # noqa: F401
    RadarProfile,
    CFARConfig,
    MTDConfig,
    G0_PROFILE,
    G1_PROFILE,
    G2_PROFILE,
)
