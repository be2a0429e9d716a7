"""Smoke test of the radar pipeline on one NVIDIA GPU.

    python chip_smoke.py          # phases 1-5 on one card
    python chip_smoke.py --four   # only the sharded G2 stream over four cards

Phases, each through the entry points a user calls:

1. device: JAX must run on a GPU (on anything else the script exits non-zero
   and prints no result); prints the card's name and power limit;
2. G2 stream: ``cli simulate`` writes a 16-channel DDC capture from a seed,
   ``cli stream`` (its ``StreamingPipeline``) beamforms it to 13 beams and
   runs 4 windows of 13 x 4 x 332 x 3404; checks the planted target and the
   RDM and flags against the float64 NumPy oracle (``tests/oracle``);
3. G0 chain: ``cli dmx`` over a frequency-agile G1-format capture; checks
   the target, that nothing compiles after the first frame, the sum RDM
   against the oracle, and times the one-executable and split forms;
4. plain-XLA stage times at G2 width (the bar a hand-written kernel must
   clear), each beside the bytes the stage must move;
5. the ``gpu``-marked tests, on the card.

``--four`` streams the same G2 capture over ``--mesh 1x4`` and ``--mesh
2x2`` and compares each with the one-card stream; it runs no other phase.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  A phase that
fails raises, so the script exits non-zero without it.  All work runs in
this one process, which owns the card(s).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# planted G2 target (the ``cli simulate`` defaults)
TARGET_V = -5.7
TARGET_R = 320.0
# RDM error against the float64 oracle, as a fraction of the RDM's peak.
# complex64 FFTs of these lengths (PC ~4k points, Doppler 332 or 2048) keep
# errors near 1e-6 of the peak; 1e-4 leaves two orders of margin and still
# catches a TF32 product (~1e-3) or a wrong transform.
RDM_BOUND = 1e-4
# Flags recomputed by the oracle from the chip's own RDM may differ only in
# cells whose CFAR test sits within this relative band of its threshold: the
# chip sums the reference cells in float32, the oracle in float64, which
# moves a threshold by a few float32 ulps (~1e-6).
THRESHOLD_BAND = 1e-5


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ------------------------------------------------------------------ helpers
class CompileCounter:
    """Counts the XLA executables built (compiles and persistent-cache
    loads alike) while it is entered, and their seconds."""

    def __init__(self):
        self.n = 0
        self.seconds = 0.0

    def __call__(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.seconds += duration

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self)
        return False


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def fmt_bytes(n) -> str:
    return "not available" if n is None else f"{n / 2**30:.3f} GiB"


def write_dbf_coeffs(path: str, n_beams: int, n_channels: int) -> int:
    """Write a DBF coefficient file (``ops.dbf.load_dbf_coeffs`` format)
    and return the beam the simulated echo arrives in.

    ``cli simulate`` gives channel ``c`` the phase ``2 pi c / 64``.  Beam
    ``b`` steers to ``k_b / 64`` cycles per channel with ``k_b = 1 + 3 (b -
    b0)``, ``b0 = n_beams // 2``: beam ``b0`` adds the channels in phase and
    the others see the echo through sidelobes 10 dB or more down (no beam
    sits on an exact null, whose float32 cancellation residue would swamp
    a parity check).
    """
    b0 = n_beams // 2
    c = np.arange(n_channels)
    rows = []
    for b in range(n_beams):
        k = 1 + 3 * (b - b0)
        w = np.exp(-2j * np.pi * c * k / 64.0) / n_channels
        rows.append(np.stack([w.real, w.imag], axis=-1).reshape(-1))
    np.savetxt(path, np.asarray(rows), fmt="%.17g")
    return b0


def threshold_margins(rdm: np.ndarray, cfg, n_clutter: int):
    """Relative CFAR margins ``x / (ref * T) - 1`` of the velocity-dim and
    the range-dim test at every cell of one segment's RDM (float64)."""
    from tests.oracle.cfar import cfar1d_ref_levels

    nv = rdm.shape[0]
    lo, hi = n_clutter + 1, nv - n_clutter
    used = rdm[lo:hi]
    mv = np.full(rdm.shape, np.inf)
    mr = np.full(rdm.shape, np.inf)
    ref_v = cfar1d_ref_levels(used.T, cfg.ref_cells, cfg.guard_cells, cfg.method).T
    ref_r = cfar1d_ref_levels(used, cfg.ref_cells, cfg.guard_cells, cfg.method)
    with np.errstate(divide="ignore", invalid="ignore"):
        mv[lo:hi] = used / (ref_v * cfg.threshold) - 1.0
        mr[lo:hi] = used / (ref_r * cfg.threshold) - 1.0
    # 0 / 0 (notched rows) decides exactly, far from any band
    return np.nan_to_num(mv, nan=np.inf), np.nan_to_num(mr, nan=np.inf)


def oracle_flags(rdm: np.ndarray, profile, n_clutter: int):
    """The oracle's cascade on ``rdm`` (already as the chip returned it),
    with the detector's /20 re-notch and per-segment CFAR.  Returns the
    flags and the mask of cells within ``THRESHOLD_BAND`` of a threshold
    that decides them."""
    from tests.oracle.cfar import execute_cfar
    from tests.oracle.dsp import zero_velocity_notch

    cfg = profile.cfar
    rdm = zero_velocity_notch(rdm, 20) if profile.mtd.fftshift else rdm
    flags = np.zeros(rdm.shape, dtype=bool)
    near = np.zeros(rdm.shape, dtype=bool)
    ext = cfg.range_extend_cells
    for a, b in profile.cfar_segments or ((0, rdm.shape[-1]),):
        seg = rdm[:, a:b]
        f, _ = execute_cfar(
            seg, cfg.ref_cells, cfg.guard_cells, cfg.threshold, cfg.method,
            cfg.ref_cells, cfg.guard_cells, cfg.threshold, cfg.method,
            n_clutter, cfg.range_detect, range_cell_nums=ext,
        )
        flags[:, a:b] = f.astype(bool)
        mv, mr = threshold_margins(seg, cfg, n_clutter)
        close_v = np.abs(mv) < THRESHOLD_BAND
        close_r = np.abs(mr) < THRESHOLD_BAND
        # a cascade mark depends on the velocity test at r-E..r+E and the
        # range test at r-2E..r+2E
        band = np.zeros(seg.shape, dtype=bool)
        for d in range(-2 * ext, 2 * ext + 1):
            band |= np.roll(close_r, d, axis=1)
            if abs(d) <= ext:
                band |= np.roll(close_v, d, axis=1)
        near[:, a:b] = band
    return flags, near


def compare_flags(chip_flags: np.ndarray, want: np.ndarray, near: np.ndarray,
                  what: str) -> int:
    """Count the differing cells; every one must be near a threshold."""
    diff = chip_flags != want
    far = diff & ~near
    check(not far.any(),
          f"{what}: {int(far.sum())} flag cells differ away from any threshold")
    return int(diff.sum())


# ------------------------------------------------------------------ phase 1
def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_device() -> dict:
    import jax

    info = device_info()
    say("jax", jax.__version__, "devices:", jax.devices())
    say("device_kind:", info["kind"], "count:", info["count"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    say("nvidia-smi name, power.limit:")
    for line in smi.splitlines():
        say(line)
    return info


# ------------------------------------------------------------------ phase 2
def simulate_g2(workdir: str, seed: int, n_frames: int,
                profile_name: str = "G2") -> tuple:
    """``cli simulate`` capture plus DBF coefficient file; returns
    (capture dir, coefficient path, target beam)."""
    from radar_signal_process_tpu import cli
    from radar_signal_process_tpu.config import PROFILES

    prof = PROFILES[profile_name]
    cap = os.path.join(workdir, "g2_capture")
    check(cli.main(["simulate", "--output", cap, "--profile", profile_name,
                    "--frames", str(n_frames), "--seed", str(seed),
                    "--velocity", str(TARGET_V), "--range", str(TARGET_R)]) == 0,
          "cli simulate failed")
    coeffs = os.path.join(workdir, "dbf_coeffs.txt")
    beam = write_dbf_coeffs(coeffs, prof.n_beams, prof.n_channels)
    return cap, coeffs, beam


def run_stream(cap: str, coeffs: str, n_frames: int, profile_name: str = "G2",
               mesh: str | None = None) -> dict:
    """Run ``cli stream --emit full`` through its ``StreamingPipeline``;
    keep every window's result on the device."""
    import jax

    from radar_signal_process_tpu import cli

    argv = ["stream", "--input", cap, "--profile", profile_name,
            "--frames", str(n_frames), "--dbf-coeffs", coeffs,
            "--emit", "full"]
    if mesh:
        argv += ["--mesh", mesh]
    args = cli.build_parser().parse_args(argv)
    pipe = cli.build_stream_pipeline(args)
    windows, wall, compiles = [], [], []
    with CompileCounter() as cc:
        t_prev = time.perf_counter()
        n_prev = 0
        for res in pipe:
            jax.block_until_ready((res.rdms, res.flags, res.detections))
            now = time.perf_counter()
            windows.append(res)
            wall.append(now - t_prev)
            compiles.append(cc.n - n_prev)
            t_prev, n_prev = now, cc.n
    return {"windows": windows, "wall": wall, "compiles": compiles,
            "compile_s": cc.seconds, "reader": type(pipe.reader).__name__,
            "counters": pipe.counters.snapshot(),
            "consumer": "host-parallel" if pipe._block_runner is not None
            else ("mesh" if mesh else "windowed")}


def check_g2_target(windows, profile, beam: int) -> tuple:
    """The planted target is detected in ``beam`` in every window, within
    one Doppler bin of its velocity, at its range column of the long
    segment.  Returns the expected (v_bin, r_col)."""
    from radar_signal_process_tpu.config import matlab_round

    v_axis = profile.velocity_axis(profile.prt_per_frame)
    v_bin = int(np.argmin(np.abs(v_axis - TARGET_V)))
    r_col = profile.segment_starts[-1] + matlab_round(TARGET_R / profile.delta_r)
    for res in windows:
        d = res.detections
        valid = np.asarray(d.valid)[beam]
        v_idx = np.asarray(d.v_idx)[beam][valid]
        r_idx = np.asarray(d.r_idx)[beam][valid]
        hit = (np.abs(v_idx - v_bin) <= 1) & (r_idx == r_col)
        check(bool(hit.any()),
              f"window {res.frame_idx}: target (v bin {v_bin}, r col {r_col}) "
              f"not detected in beam {beam}; got {list(zip(v_idx, r_idx))[:8]}")
    return v_bin, r_col


def oracle_rdm_g2(cap: str, coeffs: str, profile, frame: int, beam: int,
                  slice_idx: int, win_size: int) -> np.ndarray:
    """Float64 oracle RDM of one beam-slice: NumPy parse + DBF of frames
    ``frame`` and ``frame+1``, then the loop-style PC, Doppler and notch."""
    from radar_signal_process_tpu.config import NARROW_PULSE_FIR_TAPS
    from radar_signal_process_tpu.ingest.packets import G2FrameReader
    from radar_signal_process_tpu.models.mtd_pipeline import window_slice_starts
    from radar_signal_process_tpu.ops.dbf import load_dbf_coeffs
    from radar_signal_process_tpu.ops.waveforms import reference_pulses
    from radar_signal_process_tpu.ops.windows import make_window
    from tests.oracle import dsp

    w = load_dbf_coeffs(coeffs, profile.n_channels)
    reader = G2FrameReader(cap, profile)       # sequential: parse from frame 0
    rows = []
    for f in range(frame + 2):
        iq = reader.read_frame(f).iq
        if f >= frame:
            rows.append(iq.astype(np.complex128) @ w[beam])  # no conj (.')
    n = profile.prt_per_frame
    start = window_slice_starts(n, win_size)[slice_idx]
    echo = np.concatenate(rows, axis=0)[start : start + n]
    pc = dsp.segmented_pulse_compression(
        echo, profile.segment_points, reference_pulses(profile),
        np.asarray(NARROW_PULSE_FIR_TAPS, np.float64),
    )
    window = make_window(profile.mtd.window, n, profile.mtd.window_beta)
    rdm = dsp.doppler_process(pc, window)
    return dsp.zero_velocity_notch(rdm, profile.mtd.notch_divisor)


def g2_parity(cap, coeffs, profile, windows, picks, win_size: int = 4):
    """RDM error and flag agreement against the oracle for (window, beam,
    slice) picks."""
    from radar_signal_process_tpu.models.detect import clutter_cells

    n_clutter = clutter_cells(profile, profile.prt_per_frame)
    out = []
    for w, b, s in picks:
        res = windows[w]
        chip = np.asarray(res.rdms[b, s]).astype(np.float64)
        want = oracle_rdm_g2(cap, coeffs, profile, res.frame_idx, b, s, win_size)
        err = float(np.max(np.abs(chip - want)) / np.max(np.abs(want)))
        check(err <= RDM_BOUND,
              f"G2 RDM (window {w}, beam {b}, slice {s}): error {err:.3e} of "
              f"peak > bound {RDM_BOUND:g}")
        flags, near = oracle_flags(chip, profile, n_clutter)
        n_diff = compare_flags(np.asarray(res.flags[b, s]), flags, near,
                               f"G2 flags (window {w}, beam {b}, slice {s})")
        out.append({"window": w, "beam": b, "slice": s, "rdm_err": err,
                    "flag_cells": int(flags.sum()), "flags_differ": n_diff,
                    "near_threshold_cells": int(near.sum())})
    return out


def phase_g2(workdir: str, seed: int, profile_name: str = "G2",
             n_frames: int = 5) -> dict:
    from radar_signal_process_tpu.config import PROFILES

    prof = PROFILES[profile_name]
    cap, coeffs, beam = simulate_g2(workdir, seed, n_frames, profile_name)
    run = run_stream(cap, coeffs, n_frames, profile_name)
    windows = run["windows"]
    check(len(windows) == n_frames - 1,
          f"G2 stream: {len(windows)} windows from {n_frames} frames")
    check([r.frame_idx for r in windows] == list(range(n_frames - 1)),
          "G2 stream: windows out of order")
    shape = tuple(windows[0].rdms.shape)
    check(shape == (prof.n_beams, 4, prof.prt_per_frame, prof.point_prt),
          f"G2 RDM stack shape {shape}")
    for r in windows:
        check(bool(np.isfinite(np.asarray(r.rdms)).all()),
              f"window {r.frame_idx}: non-finite RDM")
    check(all(c == 0 for c in run["compiles"][1:]),
          f"G2 stream compiled after the first window: {run['compiles']}")
    v_bin, r_col = check_g2_target(windows, prof, beam)
    other = (beam + 1) % prof.n_beams
    parity = g2_parity(cap, coeffs, prof, windows,
                       [(0, beam, 0), (len(windows) - 1, other, 3)])
    steady = run["wall"][1:]
    say(f"G2 stream: {len(windows)} windows of {shape} via {run['consumer']} "
        f"consumer, reader {run['reader']}")
    say(f"G2 set-up (first window, compile included): {run['wall'][0]:.3f} s; "
        f"compile {run['compile_s']:.3f} s over {run['compiles'][0]} executables")
    if steady:
        say(f"G2 steady wall per window: median {np.median(steady) * 1e3:.3f} ms "
            f"(windows: {[round(t * 1e3, 3) for t in steady]})")
    c = run["counters"]
    say(f"G2 stream waits: consumer waited for ingest "
        f"{c.get('consumer_wait_s', 0.0):.3f} s, producer waited for compute "
        f"{c.get('producer_wait_s', 0.0):.3f} s over {c.get('frames_ingested')} "
        f"frames")
    say(f"G2 target: beam {beam}, v bin {v_bin} (+-1), r col {r_col}: detected "
        f"in all {len(windows)} windows")
    for p in parity:
        say(f"G2 parity window {p['window']} beam {p['beam']} slice {p['slice']}: "
            f"RDM max err {p['rdm_err']:.3e} of peak (bound {RDM_BOUND:g}); "
            f"flags {p['flag_cells']} cells, differ {p['flags_differ']}, "
            f"near-threshold cells {p['near_threshold_cells']} "
            f"(band {THRESHOLD_BAND:g})")
    say(f"G2 peak device memory (process peak so far): {fmt_bytes(peak_bytes())}")
    return {"windows": len(windows), "setup_s": run["wall"][0],
            "compile_s": run["compile_s"], "parity": parity}


# ------------------------------------------------------------------ phase 3
G0_FREQS = (2, 9, 5, 0)      # every table entry gives the same clutter cells
G0_BEAMS = (1, 4, 2, 3)
G0_DOPPLER_BIN = -60
G0_CELL_SHORT, G0_CELL_LONG = 20, 100


def synth_g0(workdir: str, seed: int, n_frames: int):
    """Frequency-agile G1-format capture with a target in both segments
    (as ``tests/test_cli_dmx.py``).  Returns (dir, left, right, fd)."""
    from radar_signal_process_tpu.config import G0_PROFILE, G0ChainConfig
    from radar_signal_process_tpu.ops.waveforms import reference_pulses
    from radar_signal_process_tpu.sim.packets_synth import write_g1_capture

    prof, cfg = G0_PROFILE, G0ChainConfig()
    rng = np.random.default_rng(seed)
    n = prof.prt_per_frame
    fd = G0_DOPPLER_BIN * prof.prf / cfg.mtd_fft_length
    p_short, p_long = reference_pulses(prof)
    ramp = np.exp(1j * 2 * np.pi * fd * np.arange(n) * prof.prt)
    base = np.zeros((n, prof.point_prt), dtype=np.complex128)
    s0, s1 = prof.segment_starts
    base[:, s0 + G0_CELL_SHORT : s0 + G0_CELL_SHORT + len(p_short)] += (
        ramp[:, None] * p_short[None, :])
    span = min(len(p_long), prof.segment_points[1] - G0_CELL_LONG)
    base[:, s1 + G0_CELL_LONG : s1 + G0_CELL_LONG + span] += (
        ramp[:, None] * p_long[None, :span])
    lefts, rights = [], []
    for _ in range(n_frames):
        noise = rng.standard_normal((2, n, prof.point_prt)) * 0.5
        lefts.append(np.round(5000.0 * base.real + noise[0])
                     + 1j * np.round(5000.0 * base.imag))
        rights.append(np.round(4000.0 * base.real + noise[1])
                      + 1j * np.round(4000.0 * base.imag))
    left, right = np.stack(lefts), np.stack(rights)
    cap = os.path.join(workdir, "g0_capture")
    write_g1_capture(cap, left, right, frames_per_file=10, angle_deg=100.0,
                     freq_index=list(G0_FREQS[:n_frames]),
                     beam_pos=list(G0_BEAMS[:n_frames]))
    return cap, left, right, fd


def run_dmx(cap: str, n_frames: int) -> dict:
    """``cli dmx`` (agile: per-frame frequency and beam from the headers),
    with ``G0Chain.process_frame`` wrapped to count compiles per frame."""
    import jax

    from radar_signal_process_tpu import cli
    from radar_signal_process_tpu.models.g0_chain import G0Chain

    per_frame, first = [], []
    orig = G0Chain.process_frame

    def counted(self, *a, **k):
        n0 = cc.n
        t0 = time.perf_counter()
        out = jax.block_until_ready(orig(self, *a, **k))
        per_frame.append((cc.n - n0, time.perf_counter() - t0))
        if not first:
            first.append(out)
        return out

    buf = io.StringIO()
    with CompileCounter() as cc:
        G0Chain.process_frame = counted
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["dmx", "--input", cap, "--frames", str(n_frames),
                               "--frame-start", "1"])
        finally:
            G0Chain.process_frame = orig
    check(rc == 0, "cli dmx failed")
    return {"out": json.loads(buf.getvalue()), "per_frame": per_frame,
            "first": first[0], "compile_s": cc.seconds}


def time_g0_forms(left: np.ndarray, right: np.ndarray, repeats: int = 5):
    """Median seconds per frame of the one-executable and split G0Chain."""
    import jax

    from radar_signal_process_tpu.models.g0_chain import G0Chain

    left = left.astype(np.complex64)
    right = right.astype(np.complex64)
    out = {}
    for name, split in (("one_executable", False), ("split", True)):
        chain = G0Chain(use_split=split)
        jax.block_until_ready(chain.process_frame(left, right))
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(chain.process_frame(left, right))
            ts.append(time.perf_counter() - t0)
        out[name] = float(np.median(ts))
    return out


def g0_parity(first, left: np.ndarray, right: np.ndarray, freq_index: int,
              beam_pos: int) -> dict:
    """``G0Chain``'s sum RDMs of the first frame against the oracle."""
    from radar_signal_process_tpu.config import (
        G0_PROFILE,
        G0ChainConfig,
        NARROW_PULSE_FIR_TAPS,
    )
    from radar_signal_process_tpu.models.g0_chain import G0Chain
    from tests.oracle.dsp import g0_sum_rdm

    prof, cfg = G0_PROFILE, G0ChainConfig()
    _, n_clutter = G0Chain(prof, cfg).frame_params(freq_index, beam_pos)
    # matched filter built as the reference does (:152-205), independent of
    # the chain's own constant
    tau2 = prof.pulse_widths[1]
    n2 = int(round(tau2 / prof.ts))
    t2 = np.arange(n2) * prof.ts - tau2 / 2.0
    mf = np.exp(1j * np.pi * (prof.bandwidth / tau2) * t2**2)
    mf = mf / np.linalg.norm(mf)
    match = np.conj(np.fft.fft(mf * np.kaiser(n2, cfg.pc_window_beta),
                               cfg.pc_fft_length))
    want_s, want_l = g0_sum_rdm(
        left, right, prof.segment_points[0],
        np.asarray(NARROW_PULSE_FIR_TAPS, np.float64), match,
        cfg.mtd_fft_length, n_clutter,
    )
    errs = {}
    for name, got, want in (("short", first.rdm_sum_short, want_s),
                            ("long", first.rdm_sum_long, want_l)):
        got = np.asarray(got).astype(np.float64)
        err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        check(err <= RDM_BOUND,
              f"G0 sum RDM {name}: error {err:.3e} of peak > {RDM_BOUND:g}")
        errs[name] = err
    return errs


def phase_g0(workdir: str, seed: int, n_frames: int = 4) -> dict:
    from radar_signal_process_tpu.config import G0_PROFILE

    prof = G0_PROFILE
    cap, left, right, fd = synth_g0(workdir, seed, n_frames)
    run = run_dmx(cap, n_frames)
    frames = run["out"]["frames"]
    check(len(frames) == n_frames, f"dmx returned {len(frames)} frames")
    check([f["freq_index"] for f in frames] == list(G0_FREQS[:n_frames]),
          "dmx did not follow the per-frame frequency index")
    c = 299792458.0
    from radar_signal_process_tpu.config import G0ChainConfig
    from radar_signal_process_tpu.ops.tables import freq_value

    cfg = G0ChainConfig()
    r_exp = G0_CELL_LONG * prof.delta_r + cfg.r_sys_err_long - cfg.r_measure_err_long
    for f in frames:
        v_exp = -(c / freq_value(f["freq_index"])) * fd / 2.0
        vels, rngs = f["long"]["velocity_ms"], f["long"]["range_m"]
        check(any(abs(v - v_exp) < 0.3 for v in vels),
              f"G0 frame {f['frame']}: velocity {vels} vs {v_exp:.3f}")
        check(any(abs(r - r_exp) < 2 * prof.delta_r for r in rngs),
              f"G0 frame {f['frame']}: range {rngs} vs {r_exp:.1f}")
    counts = [n for n, _ in run["per_frame"]]
    check(counts[0] > 0 and all(n == 0 for n in counts[1:]),
          f"G0 compiles per frame {counts}: recompiled after the first frame")
    errs = g0_parity(run["first"], left[0], right[0], G0_FREQS[0], G0_BEAMS[0])
    forms = time_g0_forms(left[0], right[0])
    say(f"G0 dmx: {n_frames} agile frames (freq {list(G0_FREQS[:n_frames])}), "
        f"target recovered in every frame")
    say(f"G0 compiles per frame: {counts}; compile {run['compile_s']:.3f} s; "
        f"frame seconds {[round(t, 4) for _, t in run['per_frame']]}")
    say(f"G0 sum RDM vs oracle: short {errs['short']:.3e}, long "
        f"{errs['long']:.3e} of peak (bound {RDM_BOUND:g})")
    say(f"G0 per frame: one-executable {forms['one_executable'] * 1e3:.3f} ms, "
        f"split {forms['split'] * 1e3:.3f} ms")
    say(f"G0 peak device memory (process peak so far): {fmt_bytes(peak_bytes())}")
    return {"compiles": counts, "rdm_err": errs, "forms": forms}


# ------------------------------------------------------------------ phase 4
def stage_times(profile_name: str = "G2", repeats: int = 10) -> dict:
    """Plain-XLA time of each G2 stage as its own jitted call."""
    import jax
    import jax.numpy as jnp

    from radar_signal_process_tpu.config import PROFILES
    from radar_signal_process_tpu.models.detect import clutter_cells, detect_rdm
    from radar_signal_process_tpu.models.mtd_pipeline import slice_cpi_window
    from radar_signal_process_tpu.ops.measure import extract_detections
    from radar_signal_process_tpu.ops.mtd import doppler_process, zero_velocity_notch
    from radar_signal_process_tpu.ops.pulse_compression import (
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu.ops.waveforms import reference_pulses
    from radar_signal_process_tpu.ops.windows import make_window

    prof = PROFILES[profile_name]
    pulses = reference_pulses(prof)
    n = prof.prt_per_frame
    window = make_window(prof.mtd.window, n, prof.mtd.window_beta)
    n_clutter = clutter_cells(prof, n)
    shape = (prof.n_beams, 2 * n, prof.point_prt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    echo = jax.block_until_ready(jax.lax.complex(
        jax.random.normal(k1, shape, jnp.float32),
        jax.random.normal(k2, shape, jnp.float32)))

    stages = {
        "pulse_compression": jax.jit(
            lambda w: slice_cpi_window(
                segmented_pulse_compression(w, prof, pulses), 4)),
        "doppler_mag_notch": jax.jit(
            lambda s: zero_velocity_notch(doppler_process(s, window),
                                          divisor=prof.mtd.notch_divisor)),
        "cfar_cascade": jax.jit(lambda r: detect_rdm(r, prof, n_clutter)[0]),
        "extraction": jax.jit(
            lambda f, r: extract_detections(f, r, 16).r_idx),
    }
    slices = stages["pulse_compression"](echo)
    rdm = stages["doppler_mag_notch"](slices)
    flags = stages["cfar_cascade"](rdm)
    args = {"pulse_compression": (echo,), "doppler_mag_notch": (slices,),
            "cfar_cascade": (rdm,), "extraction": (flags, rdm)}
    n_rdm = rdm.size
    # bytes each stage must move at least: its inputs and outputs once
    min_bytes = {
        "pulse_compression": echo.size * 8 + slices.size * 8,
        "doppler_mag_notch": slices.size * 8 + n_rdm * 4,
        "cfar_cascade": n_rdm * 4 + n_rdm,
        "extraction": n_rdm + n_rdm * 4,
    }
    out = {}
    for name, fn in stages.items():
        a = args[name]
        ca = fn.lower(*a).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts))
        out[name] = {"ms": t * 1e3, "min_gb": min_bytes[name] / 1e9,
                     "xla_gb": float(ca.get("bytes accessed", 0.0)) / 1e9,
                     "gb_per_s": min_bytes[name] / t / 1e9}
    return out


def phase_stages(profile_name: str = "G2") -> dict:
    out = stage_times(profile_name)
    say("plain-XLA stage times at G2 width (median of 10, block_until_ready):")
    for name, r in out.items():
        say(f"  {name:18s} {r['ms']:10.3f} ms  must move {r['min_gb']:.4f} GB "
            f"({r['gb_per_s']:.1f} GB/s); XLA counts {r['xla_gb']:.4f} GB")
    return out


# ------------------------------------------------------------------ phase 5
def phase_gpu_tests() -> int:
    import pytest

    os.environ["RSP_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO, os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")
    return int(rc)


# ------------------------------------------------------------------ --four
def compare_stream_runs(base: dict, run: dict, profile, beam: int,
                        what: str) -> dict:
    """A mesh stream against the one-card stream on the same capture."""
    from radar_signal_process_tpu.models.detect import clutter_cells, make_detector

    bw, rw = base["windows"], run["windows"]
    check([r.frame_idx for r in rw] == [r.frame_idx for r in bw],
          f"{what}: windows {[r.frame_idx for r in rw]} vs "
          f"{[r.frame_idx for r in bw]}")
    check_g2_target(rw, profile, beam)
    n_clutter = clutter_cells(profile, profile.prt_per_frame)
    detect = make_detector(profile, n_clutter=n_clutter)
    rdm_err, n_diff = 0.0, 0
    for a, b in zip(bw, rw):
        ra, rb = np.asarray(a.rdms), np.asarray(b.rdms)
        check(ra.shape == rb.shape, f"{what}: RDM shape {rb.shape} vs {ra.shape}")
        rdm_err = max(rdm_err, float(np.max(np.abs(ra - rb)) / np.max(ra)))
        # flags recomputed from this run's own RDM by the one-device detector
        want = np.asarray(detect(b.rdms)[0])
        got = np.asarray(b.flags)
        if (got != want).any():
            for idx in zip(*np.nonzero((got != want).any(axis=(-1, -2)))):
                plane = rb[idx].astype(np.float64)
                o_flags, near = oracle_flags(plane, profile, n_clutter)
                n_diff += compare_flags(got[idx], want[idx], near,
                                        f"{what} flags {idx}")
    check(rdm_err <= RDM_BOUND,
          f"{what}: RDM differs from the one-card stream by {rdm_err:.3e} of peak")
    devices = sorted(d.id for d in rw[0].rdms.sharding.device_set)
    return {"rdm_err": rdm_err, "flags_differ": n_diff, "devices": devices}


def phase_four(workdir: str, seed: int, profile_name: str = "G2",
               n_frames: int = 5, meshes=("1x4", "2x2")) -> dict:
    import jax

    from radar_signal_process_tpu.config import PROFILES

    prof = PROFILES[profile_name]
    need = max(int(a) * int(b) for a, b in (m.split("x") for m in meshes))
    check(len(jax.devices()) >= need,
          f"--four needs {need} devices, JAX has {len(jax.devices())}")
    cap, coeffs, beam = simulate_g2(workdir, seed, n_frames, profile_name)
    base = run_stream(cap, coeffs, n_frames, profile_name)
    check_g2_target(base["windows"], prof, beam)
    out = {}
    for mesh in meshes:
        run = run_stream(cap, coeffs, n_frames, profile_name, mesh=mesh)
        res = compare_stream_runs(base, run, prof, beam, f"mesh {mesh}")
        check(len(res["devices"]) == need,
              f"mesh {mesh}: results live on devices {res['devices']}")
        steady = run["wall"][1:]
        say(f"mesh {mesh}: {len(run['windows'])} windows in order, target found; "
            f"RDM vs one card {res['rdm_err']:.3e} of peak; flags recomputed "
            f"from its own RDM differ in {res['flags_differ']} cells; devices "
            f"{res['devices']}; set-up {run['wall'][0]:.3f} s, steady "
            f"{(np.median(steady) * 1e3 if steady else float('nan')):.3f} ms/window")
        out[mesh] = res
    steady = base["wall"][1:]
    say(f"one card: set-up {base['wall'][0]:.3f} s, steady "
        f"{(np.median(steady) * 1e3 if steady else float('nan')):.3f} ms/window")
    return out


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the G2 stream over --mesh 1x4 and 2x2 (4 cards)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX runs on "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from radar_signal_process_tpu.ingest import native_available
    from radar_signal_process_tpu.utils.compile_cache import enable_compile_cache

    say("compile cache:", enable_compile_cache())
    info = phase_device()
    say("native ingest reader:", "yes" if native_available() else "no (NumPy)")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            phase_four(workdir, args.seed)
        else:
            t0 = time.perf_counter()
            phase_g2(workdir, args.seed)
            say(f"phase G2 stream done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_g0(workdir, args.seed)
            say(f"phase G0 chain done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_stages()
            say(f"phase stage times done in {time.perf_counter() - t0:.1f} s")
            phase_gpu_tests()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
