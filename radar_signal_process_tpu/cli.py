"""Command-line drivers (reference layer L4 as thin CLIs, SURVEY.md §7.1).

Replaces the reference's edit-then-run driver scripts with stage commands:

* ``simulate`` — synthesize a G2 capture (raw ``.bin`` packets) containing a
  moving target in clutter (reference S1-S3 as a tool);
* ``ingest``   — parse ``.bin`` captures (native C++ or NumPy), apply DBF,
  persist per-frame ``.npz`` manifests (stage 1, ``bin_to_mat_xzr.m``);
* ``mtd``      — windowed MTD over frame pairs (stage 2,
  ``main_produce_dataset_win_xzr_v2.m``);
* ``detect``   — cascaded CFAR + detection lists (stage 3, ``main_cfar.m``);
* ``e2e``      — fused ingest->MTD->CFAR->measure in memory, no file bus.

Every stage is frame-keyed and idempotent: existing outputs are skipped,
preserving the reference's restart-anywhere property with config embedded in
each artifact (SURVEY.md §5.4).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from radar_signal_process_tpu.config import PROFILES
from radar_signal_process_tpu.utils import (
    Counters,
    StageTimers,
    frame_exists,
    get_logger,
    load_frame,
    save_frame,
)

log = get_logger("radar_tpu.cli")


def _stage_exists(directory: str, frame_idx: int, fmt: str) -> bool:
    """Frame-keyed idempotence check for either artifact format."""
    from radar_signal_process_tpu.utils import matbus

    if fmt == "mat":
        return matbus.mat_frame_exists(directory, frame_idx)
    return frame_exists(directory, frame_idx)


def _load_stage1(directory: str, frame_idx: int, profile):
    """Load a stage-1 frame from either the ``.npz`` manifest or the
    reference's MATLAB ``frame_N.mat`` bus (``bin_to_mat_xzr.m:66``)."""
    import os

    from radar_signal_process_tpu.utils import matbus
    from radar_signal_process_tpu.utils.manifest import frame_path

    if os.path.exists(frame_path(directory, frame_idx)):
        return load_frame(directory, frame_idx)
    if matbus.mat_frame_exists(directory, frame_idx):
        iq, servo = matbus.load_frame_mat(matbus.mat_frame_path(directory, frame_idx))
        return {"iq": iq, "servo_angle": servo}, profile, {"format": "mat"}
    raise FileNotFoundError(frame_path(directory, frame_idx))


def _load_rdms(directory: str, frame_idx: int, profile):
    """Load stage-2 RDMs (beam, win, v, r) from ``.npz`` or MATLAB form."""
    import os

    from radar_signal_process_tpu.utils import matbus
    from radar_signal_process_tpu.utils.manifest import frame_path

    if os.path.exists(frame_path(directory, frame_idx)):
        arrays, prof, meta = load_frame(directory, frame_idx)
        return arrays["rdm"], prof, meta
    if matbus.mat_frame_exists(directory, frame_idx):
        rdm = matbus.load_mtd_mat(matbus.mat_frame_path(directory, frame_idx))
        return rdm, profile, {"format": "mat"}
    raise FileNotFoundError(frame_path(directory, frame_idx))


def cmd_simulate(args) -> int:
    from radar_signal_process_tpu.sim import (
        add_clutter,
        apply_scr,
        synthesize_target_echo,
        synthetic_clutter,
    )
    from radar_signal_process_tpu.sim.packets_synth import write_g2_capture

    profile = PROFILES[args.profile]
    n = profile.prt_per_frame
    rng = np.random.default_rng(args.seed)
    frames = np.zeros(
        (args.frames, n, profile.point_prt, profile.n_channels), dtype=np.complex128
    )
    target = synthesize_target_echo(
        profile, args.velocity, args.range, n_pulses=args.frames * n
    )
    clutter = synthetic_clutter(profile, n_pulses=args.frames * n, seed=args.seed)
    echo = add_clutter(apply_scr(target, clutter, args.scr, profile), clutter)
    # quantize to int16-scale DDC samples; same echo into every channel with
    # a per-channel phase ramp so DBF has structure to work with
    scale = 3000.0 / (np.abs(echo).max() + 1e-30)
    phases = np.exp(1j * 2 * np.pi * np.arange(profile.n_channels) / 64.0)
    for f in range(args.frames):
        block = echo[f * n : (f + 1) * n] * scale
        frames[f] = np.round(block[..., None].real * phases.real
                             - block[..., None].imag * phases.imag) + 1j * np.round(
            block[..., None].real * phases.imag + block[..., None].imag * phases.real
        )
    write_g2_capture(args.output, frames, profile, data_type=1,
                     file_sizes=[args.file_bytes] * 1000 if args.file_bytes else None)
    log.info("wrote %d synthetic frames to %s", args.frames, args.output)
    return 0


def _ingest_g1(args, profile) -> int:
    """G1/G0 stage-1: 24-bit packed dual-beam capture -> per-frame artifacts.

    The reference's G1 stage-1 driver (``MatlabProcess_xuzerui/
    bin_to_mat_xzr.m:14-22``) loops frames through ``frameDataRead_A`` and
    saves ``echoData_Frame_0/1`` + ``angleCodeSeries`` per frame; there is
    no mid-frame retry (EOF simply ends the run).
    """
    from radar_signal_process_tpu.ingest import native_available
    from radar_signal_process_tpu.ingest.packets import G1FrameReader

    reader_cls = G1FrameReader
    if args.native and native_available():
        from radar_signal_process_tpu.ingest.native_loader import NativeG1FrameReader

        reader_cls = NativeG1FrameReader
    reader = reader_cls(
        args.input,
        prt_num=profile.prt_per_frame,
        point_prt=profile.point_prt,
        frames_per_file=args.frames_per_file,
    )
    log.info("ingest using %s G1 parser",
             "native C++" if reader_cls is not G1FrameReader else "NumPy")
    counters = Counters()
    for out_idx in range(args.frames):
        if _stage_exists(args.output, out_idx, args.format) and not args.force:
            continue
        try:
            # artifact index is 0-based; the packet reader is 1-based
            left, right, angles, meta = reader.read_frame(out_idx + 1)
        except (OSError, EOFError) as e:
            # missing next file / truncated frame = end of capture (the
            # reference's G1 driver also just stops); the NumPy reader
            # raises FileNotFoundError/EOFError, the native one IOError
            # with the C return code (-1 open, -2 short read)
            log.info("end of stream at frame %d (%s)", out_idx, e)
            break
        if args.format == "mat":
            from radar_signal_process_tpu.utils import matbus

            matbus.save_g1_frame_mat(
                matbus.mat_frame_path(args.output, out_idx), left, right, angles
            )
        else:
            iq = np.stack([left, right], axis=-1)  # (prt, sample, beam)
            save_frame(
                args.output, out_idx,
                {"iq": iq, "servo_angle": angles},
                profile, meta={"dbf": False, **{k: int(v) for k, v in meta.items()}},
            )
        if getattr(args, "debug_plots", None):
            # Show_Read-style live I/Q view (Show_Read.m:127-136), one
            # static panel per ingested frame
            import os

            from radar_signal_process_tpu.viz import plot_iq_debug

            os.makedirs(args.debug_plots, exist_ok=True)
            plot_iq_debug(
                left, right, prt_index=0, frame_index=out_idx,
                save_path=os.path.join(
                    args.debug_plots, f"iq_frame_{out_idx}.png"
                ),
            )
        counters.add("frames")
        counters.add("prts", profile.prt_per_frame)
    log.info("ingest done: %s", counters)
    return 0


def cmd_ingest(args) -> int:
    from radar_signal_process_tpu.ingest import G2FrameReader, native_available
    from radar_signal_process_tpu.ingest.native_loader import NativeG2FrameReader

    profile = PROFILES[args.profile]
    if profile.bytes_head != 64:
        # G1/G0 captures are the 24-bit packed dual-beam format; the G2
        # packet parser would misread them (VERDICT r2: G1 stage-1 wiring)
        return _ingest_g1(args, profile)
    use_native = args.native and native_available()
    reader = (NativeG2FrameReader if use_native else G2FrameReader)(args.input, profile)
    log.info("ingest using %s parser", "native C++" if use_native else "NumPy")

    if args.dbf_coeffs:
        from radar_signal_process_tpu.ops.dbf import load_dbf_coeffs

        coeffs = load_dbf_coeffs(args.dbf_coeffs, profile.n_channels)
    else:
        coeffs = None

    counters = Counters()
    frame_idx, retries = 0, 0
    while frame_idx < args.frames:
        if _stage_exists(args.output, frame_idx, args.format) and not args.force:
            frame_idx += 1
            continue
        res = reader.read_frame(frame_idx)
        if res.frame_completed:
            iq = res.iq
            if coeffs is not None:
                import jax.numpy as jnp

                from radar_signal_process_tpu.ops.dbf import apply_dbf

                iq = np.asarray(apply_dbf(jnp.asarray(iq), coeffs.astype(np.complex64)))
            if args.format == "mat":
                from radar_signal_process_tpu.utils import matbus

                matbus.save_frame_mat(
                    matbus.mat_frame_path(args.output, frame_idx),
                    iq, res.servo_angle,
                )
            else:
                save_frame(
                    args.output, frame_idx,
                    {"iq": iq, "servo_angle": res.servo_angle},
                    profile, meta={"dbf": coeffs is not None},
                )
            counters.add("frames")
            counters.add("prts", profile.prt_per_frame)
            frame_idx += 1
            retries = 0
        else:
            if res.eos:
                log.info("end of stream at frame %d", frame_idx)
                break
            retries += 1
            counters.add("retries")
            if retries > args.max_retries:  # bin_to_mat_xzr.m:81-84
                log.error("frame %d failed %d retries; aborting", frame_idx, retries)
                return 1
    log.info("ingest done: %s", counters)
    return 0


def _parse_match_waveforms(args, profile):
    """``--match-waveform SEG=PATH[:VAR]`` specs -> pulses tuple (or None).

    The measured matched-filter hook (``fun_MTD_produce.m:72-78`` /
    ``temp.m:50-56``), shared by the mtd and stream commands.
    """
    if not getattr(args, "match_waveform", None):
        return None
    from radar_signal_process_tpu.ops.waveforms import (
        load_measured_pulse,
        pulses_with_overrides,
    )

    overrides = {}
    for spec in args.match_waveform:
        seg_s, _, rest = spec.partition("=")
        if not rest:
            raise SystemExit(
                f"--match-waveform needs SEG=PATH[:VAR], got {spec!r}"
            )
        path, _, var = rest.partition(":")
        overrides[int(seg_s)] = load_measured_pulse(path, var or None)
    return pulses_with_overrides(profile, overrides)


def cmd_mtd(args) -> int:
    import jax
    import jax.numpy as jnp

    from radar_signal_process_tpu.models.mtd_pipeline import make_frame_processor

    profile = PROFILES[args.profile]
    stc_curve = None
    if getattr(args, "istc", None):
        # iSTC gain compensation (fun_iSTC.m:6-15): load the textread-style
        # dB curve and switch the dormant hook on for this run
        import dataclasses as dc

        from radar_signal_process_tpu.utils.dataset import load_stc_curve

        stc_curve = load_stc_curve(args.istc)
        profile = dc.replace(profile, mtd=dc.replace(profile.mtd, istc=True))
    pulses = _parse_match_waveforms(args, profile)
    if jax.default_backend() == "cpu":
        # host-thread fan-out over beam chunks with split stage executables
        # plus per-frame PC reuse across consecutive windows (see
        # models.host_parallel) — ~2x on multi-core CPU hosts
        from radar_signal_process_tpu.models.host_parallel import (
            make_cpu_stream_processor,
        )

        process = make_cpu_stream_processor(
            profile, win_size=args.win_size, stc_curve_db=stc_curve,
            pulses=pulses,
        )
    else:
        _p = make_frame_processor(
            profile, win_size=args.win_size, stc_curve_db=stc_curve,
            pulses=pulses,
        )

        def process(a, b, frame_idx=None):
            return _p(a, b)

    timers = StageTimers()
    done = 0
    for frame_idx in range(args.frames):
        if _stage_exists(args.output, frame_idx, args.format) and not args.force:
            done += 1
            continue
        try:
            now, _, _ = _load_stage1(args.input, frame_idx, profile)
            nxt, _, _ = _load_stage1(args.input, frame_idx + 1, profile)
        except FileNotFoundError:
            log.warning("frames %d/%d unavailable; stopping", frame_idx, frame_idx + 1)
            break
        # iq arrays are (prt, samples, beams-or-channels) -> (beams, prt, samples)
        a = np.moveaxis(now["iq"], -1, 0)
        b = np.moveaxis(nxt["iq"], -1, 0)
        with timers.stage("mtd") as h:
            rdms = process(
                jnp.asarray(a, jnp.complex64), jnp.asarray(b, jnp.complex64),
                frame_idx=frame_idx,
            )
            h["fence"] = rdms
        if args.format == "mat":
            from radar_signal_process_tpu.utils import matbus

            matbus.save_mtd_mat(
                matbus.mat_frame_path(args.output, frame_idx), np.asarray(rdms),
                # the G1 two-beam stage saves MTD_0/MTD_1 variables
                two_beam_vars=(profile.bytes_head != 64
                               and np.asarray(rdms).shape[0] == 2),
            )
        else:
            save_frame(
                args.output, frame_idx,
                {"rdm": np.asarray(rdms), "servo_angle": now["servo_angle"]},
                profile,
                meta={"win_size": args.win_size,
                      "istc": stc_curve is not None},
            )
        done += 1
    log.info("mtd done (%d frames)\n%s", done, timers.report())
    return 0


def _detect_sweep(args, profile) -> int:
    """Stage-3 threshold sweep over the file bus (``main_cfar.m:40``).

    The reference loops ``for T=[...]`` over the loaded stage-2 frames and
    writes one ``cfarFlag{win}_T{T}`` directory per threshold.  The CA-CFAR
    reference levels are threshold-independent, so each frame computes the
    sliding-window levels ONCE and re-runs only the compare + cascade per
    threshold — with the threshold traced, one executable covers the whole
    sweep.
    """
    import functools
    import os

    import jax
    import jax.numpy as jnp

    from radar_signal_process_tpu.models.detect import clutter_cells
    from radar_signal_process_tpu.ops.cfar import (
        segmented_cfar_from_ref_levels,
        segmented_cfar_ref_levels,
    )
    from radar_signal_process_tpu.ops.measure import extract_detections
    from radar_signal_process_tpu.ops.mtd import (
        zero_velocity_notch,
        zero_velocity_notch_unshifted,
    )
    from radar_signal_process_tpu.utils import matbus

    cfg = profile.cfar
    segments = None
    timers = StageTimers()

    def t_name(t: float) -> str:
        return str(int(t)) if float(t).is_integer() else str(t)

    def out_dir(t: float, win_size: int) -> str:
        if args.format == "mat":
            # the reference's exact cfarFlag{win}_T{T} directory contract
            return matbus.cfar_dir(args.output, win_size, t)
        return f"{args.output}_T{t_name(t)}"

    prep = None
    done = 0
    for frame_idx in range(args.frames):
        try:
            rdm_arr, _, meta = _load_rdms(args.input, frame_idx, profile)
        except FileNotFoundError:
            break
        win_size = rdm_arr.shape[-3] if rdm_arr.ndim >= 3 else 1
        if all(
            _stage_exists(out_dir(t, win_size), frame_idx, args.format)
            for t in args.thresholds
        ) and not args.force:
            done += 1
            continue
        rdms = jnp.asarray(rdm_arr)
        if prep is None:
            nc = clutter_cells(profile, rdms.shape[-2], args.clutter_v)
            segments = profile.cfar_segments or ((0, rdms.shape[-1]),)

            @jax.jit
            def prep(r):
                rn = (
                    zero_velocity_notch(r, divisor=20)
                    if profile.mtd.fftshift
                    else zero_velocity_notch_unshifted(r, nc)
                )
                vref, rref = segmented_cfar_ref_levels(rn, segments, cfg, nc)
                return rn, vref, rref

            @jax.jit
            def flags_at(rn, vref, rref, t):
                return segmented_cfar_from_ref_levels(
                    rn, vref, rref, t, segments, cfg, nc
                )

            extract = jax.jit(functools.partial(
                extract_detections, max_detections=args.max_detections
            ))

        with timers.stage("cfar_sweep") as h:
            rn, vref, rref = prep(rdms)
            for t in args.thresholds:
                flags, vflags = flags_at(rn, vref, rref, float(t))
                dets = extract(flags, rdms)
                d = out_dir(float(t), win_size)
                if args.format == "mat":
                    matbus.save_cfar_mat(
                        matbus.mat_frame_path(d, frame_idx), np.asarray(flags)
                    )
                else:
                    save_frame(
                        d, frame_idx,
                        {
                            "flags": np.asarray(flags),
                            "vflags": np.asarray(vflags),
                            "det_v": np.asarray(dets.v_idx),
                            "det_r": np.asarray(dets.r_idx),
                            "det_amp": np.asarray(dets.amplitude),
                            "det_valid": np.asarray(dets.valid),
                        },
                        profile, meta={"threshold": float(t)},
                    )
                h["fence"] = flags
        done += 1
    log.info("detect sweep done (%d frames x %d thresholds)\n%s",
             done, len(args.thresholds), timers.report())
    return 0


def cmd_detect(args) -> int:
    import jax.numpy as jnp

    from radar_signal_process_tpu.models.detect import clutter_cells, make_detector

    profile = PROFILES[args.profile]
    if getattr(args, "thresholds", None):
        return _detect_sweep(args, profile)
    detector = None
    timers = StageTimers()
    done = 0
    if args.spectral_width_db is not None and args.format == "mat":
        log.warning(
            "--format mat writes only the reference's cfarFlag variables; "
            "per-detection spectral widths are not computed or persisted "
            "(use the npz format)"
        )
    for frame_idx in range(args.frames):
        if _stage_exists(args.output, frame_idx, args.format) and not args.force:
            done += 1
            continue
        try:
            rdm_arr, _, meta = _load_rdms(args.input, frame_idx, profile)
        except FileNotFoundError:
            break
        import jax as _jax

        # CPU: keep the stack host-side — make_cpu_flags slices numpy views
        # and each per-RDM executable uploads its own input exactly once
        # (wrapping in jnp first would add a full round-trip)
        rdms = rdm_arr if _jax.default_backend() == "cpu" else jnp.asarray(rdm_arr)
        if detector is None:
            import dataclasses as dc

            import jax

            cfg = dc.replace(profile.cfar, threshold=args.threshold)
            nc = clutter_cells(profile, rdms.shape[-2], args.clutter_v)
            if jax.default_backend() == "cpu":
                from functools import partial

                from radar_signal_process_tpu.models.host_parallel import (
                    make_cpu_flags,
                )
                from radar_signal_process_tpu.ops.measure import extract_detections

                flags_fn = make_cpu_flags(profile, nc, cfg=cfg)
                extract = jax.jit(
                    partial(extract_detections, max_detections=args.max_detections)
                )

                def detector(r):
                    f, v = flags_fn(r)
                    return f, v, extract(jnp.asarray(f), r)

            else:
                detector = make_detector(
                    profile, n_clutter=nc, max_detections=args.max_detections,
                    cfg=cfg,
                )
        with timers.stage("cfar") as h:
            flags, vflags, dets = detector(rdms)
            h["fence"] = flags
        det_width = None
        if args.spectral_width_db is not None and args.format != "mat":
            from radar_signal_process_tpu.ops.spectrum import (
                detection_spectral_widths,
            )

            det_width = np.asarray(detection_spectral_widths(
                rdms, dets.r_idx, args.spectral_width_db,
                shifted_input=profile.mtd.fftshift,
                interp=args.spectral_width_interp > 1,
                interp_times=max(args.spectral_width_interp, 1),
            ))
        if args.format == "mat":
            from radar_signal_process_tpu.utils import matbus

            matbus.save_cfar_mat(
                matbus.mat_frame_path(args.output, frame_idx), np.asarray(flags)
            )
        else:
            save_frame(
                args.output, frame_idx,
                {
                    "flags": np.asarray(flags),
                    "vflags": np.asarray(vflags),
                    "det_v": np.asarray(dets.v_idx),
                    "det_r": np.asarray(dets.r_idx),
                    "det_amp": np.asarray(dets.amplitude),
                    "det_valid": np.asarray(dets.valid),
                    **({"det_width": det_width} if det_width is not None else {}),
                },
                profile, meta={"threshold": args.threshold},
            )
        done += 1
    log.info("detect done (%d frames)\n%s", done, timers.report())
    return 0


def cmd_e2e(args) -> int:
    """Fused in-memory chain: .bin capture -> detections, no file bus."""
    import jax
    import jax.numpy as jnp

    from radar_signal_process_tpu.ingest import G2FrameReader, native_available
    from radar_signal_process_tpu.ingest.native_loader import NativeG2FrameReader
    from radar_signal_process_tpu.models.detect import clutter_cells, make_detector
    from radar_signal_process_tpu.models.mtd_pipeline import make_frame_processor

    profile = PROFILES[args.profile]
    reader_cls = NativeG2FrameReader if (args.native and native_available()) else G2FrameReader
    reader = reader_cls(args.input, profile)
    sharded_run = None
    if getattr(args, "mesh", None):
        # multi-device execution: beams sharded over dp, range over sp with
        # halo-exchange CFAR (parallel.make_sharded_pipeline); detections
        # extracted from the selected beam/slice exactly like the
        # single-device path
        from radar_signal_process_tpu.models.mtd_pipeline import (
            window_slice_starts,
        )
        from radar_signal_process_tpu.ops.measure import extract_detections
        from radar_signal_process_tpu.parallel import make_mesh
        from radar_signal_process_tpu.parallel.sharding import (
            make_sharded_pipeline,
            shard_batch,
        )

        dp, sp = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(("dp", "sp"), shape=(dp, sp),
                         devices=jax.devices()[: dp * sp])
        nc = clutter_cells(profile, profile.prt_per_frame, args.clutter_v)
        sharded_run = make_sharded_pipeline(
            profile, mesh, n_clutter=nc, renotch_divisor=20
        )
        slice_start = window_slice_starts(profile.prt_per_frame,
                                          args.win_size)[args.win_slice]
        extract = jax.jit(
            lambda flags, rdm: extract_detections(flags, rdm,
                                                  args.max_detections)
        )
        beam_pad = (-profile.n_beams) % dp

    process = make_frame_processor(profile, win_size=args.win_size)
    detector = None
    timers = StageTimers()

    def _det_rows(dets, beams, wins):
        """Batched DetectionList -> sorted [beam, win, v, r, amp] rows."""
        valid = np.asarray(dets.valid)
        v_idx = np.asarray(dets.v_idx)
        r_idx = np.asarray(dets.r_idx)
        amp = np.asarray(dets.amplitude)
        rows = []
        for b in beams:
            for w in wins:
                sel = valid[b, w] if valid.ndim == 3 else valid[b]
                vv = v_idx[b, w] if valid.ndim == 3 else v_idx[b]
                rr = r_idx[b, w] if valid.ndim == 3 else r_idx[b]
                aa = amp[b, w] if valid.ndim == 3 else amp[b]
                rows.extend(
                    [int(b), int(w), int(v), int(r), float(a)]
                    for v, r, a in zip(vv[sel], rr[sel], aa[sel])
                )
        return rows

    prev = None
    results = []
    for frame_idx in range(args.frames + 1):
        with timers.stage("read"):
            res = reader.read_frame(frame_idx)
        if not res.frame_completed:
            break
        cur = np.ascontiguousarray(np.moveaxis(res.iq, -1, 0))
        if prev is not None and sharded_run is not None:
            with timers.stage("mtd+cfar") as h:
                win = np.concatenate([prev, cur], axis=-2)
                echo = win[:, slice_start : slice_start + profile.prt_per_frame]
                if beam_pad:
                    echo = np.concatenate(
                        [echo, np.zeros((beam_pad,) + echo.shape[1:],
                                        echo.dtype)], axis=0,
                    )
                x = jax.device_put(jnp.asarray(echo, jnp.complex64),
                                   shard_batch(mesh, "dp"))
                rdm, flags, _ = sharded_run(x)
                # all real beams of the sharded slice (padding dropped)
                dets = extract(flags[: profile.n_beams],
                               rdm[: profile.n_beams])
                h["fence"] = dets.valid
            rows = _det_rows(dets, range(profile.n_beams), [args.win_slice])
        elif prev is not None:
            with timers.stage("mtd+cfar") as h:
                rdms = process(
                    jnp.asarray(prev, jnp.complex64), jnp.asarray(cur, jnp.complex64)
                )
                if detector is None:
                    nc = clutter_cells(profile, rdms.shape[-2], args.clutter_v)
                    detector = make_detector(
                        profile, n_clutter=nc, max_detections=args.max_detections
                    )
                # every (beam, slice), as the reference's stage 3 does
                # (main_cfar.m:85-96)
                flags, _, dets = detector(rdms)
                h["fence"] = flags
            rows = _det_rows(
                dets, range(rdms.shape[0]), range(rdms.shape[1])
            )
        if prev is not None:
            results.append({"frame": frame_idx - 1, "detections": rows})
        prev = cur
    print(json.dumps({"frames": results}, indent=None))
    log.info("e2e timing\n%s", timers.report())
    return 0


def build_stream_pipeline(args):
    """The ``StreamingPipeline`` that ``stream`` runs for parsed ``args``
    (reader, DBF coefficients, mesh, iSTC and matched-filter hooks)."""
    from radar_signal_process_tpu.ingest import G2FrameReader, native_available
    from radar_signal_process_tpu.models.streaming import StreamingPipeline

    profile = PROFILES[args.profile]
    if profile.bytes_head != 64:
        raise SystemExit(
            f"stream supports G2-format captures only (profile "
            f"{profile.name}); use `dmx` for G1/G0 dual-beam captures"
        )
    reader_cls = G2FrameReader
    if args.native and native_available():
        from radar_signal_process_tpu.ingest.native_loader import (
            NativeG2FrameReader,
        )

        reader_cls = NativeG2FrameReader
    coeffs = None
    if args.dbf_coeffs:
        from radar_signal_process_tpu.ops.dbf import load_dbf_coeffs

        coeffs = load_dbf_coeffs(args.dbf_coeffs, profile.n_channels)
    mesh = None
    if getattr(args, "mesh", None):
        import jax

        from radar_signal_process_tpu.parallel import make_mesh

        dp, sp = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(("dp", "sp"), shape=(dp, sp),
                         devices=jax.devices()[: dp * sp])
    stc_curve = None
    if getattr(args, "istc", None):
        import dataclasses as dc

        from radar_signal_process_tpu.utils.dataset import load_stc_curve

        stc_curve = load_stc_curve(args.istc)
        profile = dc.replace(profile, mtd=dc.replace(profile.mtd, istc=True))
    return StreamingPipeline(
        reader_cls(args.input, profile),
        profile,
        win_size=args.win_size,
        max_frames=args.frames,
        clutter_v=args.clutter_v,
        max_detections=args.max_detections,
        dbf_coeffs=coeffs,
        mesh=mesh,
        stc_curve_db=stc_curve,
        pulses=_parse_match_waveforms(args, profile),
        block_windows=args.block_windows,
        emit=args.emit,
    )


def cmd_stream(args) -> int:
    """Streaming chain: overlapped host ingest + compute, all-beam detection.

    Drives ``models.streaming.StreamingPipeline`` (the production fused
    path: background C++ parse + prefetch, per-frame PC reuse, detection
    over every (beam, slice), per-frame hit counters and latency stats).
    """
    import time as _time

    pipe = build_stream_pipeline(args)
    frames_out = []
    t_prev = _time.perf_counter()
    for res in pipe:
        now = _time.perf_counter()
        valid = np.asarray(res.detections.valid)
        frames_out.append({
            "frame": res.frame_idx,
            "window_latency_ms": round((now - t_prev) * 1e3, 1),
            "cfar_hits": res.cfar_hits,
            "detections_per_beam": valid.any(axis=-1).sum(axis=-1).tolist(),
        })
        t_prev = now
    print(json.dumps({
        "frames": frames_out,
        "counters": pipe.counters.snapshot(),
    }))
    return 0


def cmd_sweep(args) -> int:
    """Threshold x SCR sweep with the S4 detection metrics (main_cfar's
    ``for T=[5]`` loop generalized; build plan §7.2 item 8)."""
    from radar_signal_process_tpu.evalx.sweep import format_sweep, sweep_thresholds

    profile = PROFILES[args.profile]
    results = sweep_thresholds(
        profile,
        thresholds=args.thresholds,
        scr_db=args.scr,
        velocity_ms=args.velocity,
        range_m=args.range,
        n_frames=args.frames,
        clutter_v=args.clutter_v,
    )
    print(format_sweep(results))

    def clean(m):
        return {k: (None if v != v else v) for k, v in m.items()}

    print(json.dumps({f"{scr}/{t}": clean(m) for (scr, t), m in results.items()}))
    return 0


def cmd_analyze(args) -> int:
    """Reload stage-2 RDM manifests and render dashboards (reference V3).

    Unlike ``analyze_and_plot_mtd_results.m`` — which must re-declare the
    radar parameters because the reference never stored them — the profile
    is recovered from the artifact itself.
    """
    from radar_signal_process_tpu.viz import plot_mtd_dashboard

    import os

    os.makedirs(args.output, exist_ok=True)
    rdm, profile, meta = _load_rdms(args.input, args.frame, PROFILES[args.profile])
    rdm = np.asarray(rdm)
    if rdm.ndim == 4:
        rdm = rdm[args.beam, args.win_slice]
    outputs = [plot_mtd_dashboard(
        rdm, profile,
        save_path=os.path.join(
            args.output, f"frame_{args.frame}_b{args.beam}_s{args.win_slice}.png"
        ),
    )]
    if args.animate in ("doppler", "all"):
        # reference V1 mode 2: per-range-bin Doppler spectrum animation
        # (MTD/fun_plot_visualizations.m:51-63)
        from radar_signal_process_tpu.viz import plot_doppler_animation

        outputs.append(plot_doppler_animation(
            rdm, profile.velocity_axis(rdm.shape[-2]),
            save_path=os.path.join(args.output, "doppler_anim.gif"),
            step=args.animate_step, max_frames=args.animate_frames,
        ))
    if args.animate in ("pc", "all"):
        # reference V1 mode 1: per-PRT compressed-pulse animation
        # (MTD/fun_plot_visualizations.m:33-49), recomputed from the
        # stage-1 artifact the RDM was produced from
        if not args.stage1_input:
            raise SystemExit("--animate pc needs --stage1-input DIR")
        import jax.numpy as jnp

        from radar_signal_process_tpu.ops.pulse_compression import (
            segmented_pulse_compression,
        )
        from radar_signal_process_tpu.ops.waveforms import reference_pulses
        from radar_signal_process_tpu.viz import plot_pc_animation

        arrays, prof1, _ = _load_stage1(args.stage1_input, args.frame, profile)
        echo = np.moveaxis(arrays["iq"], -1, 0)[args.beam]
        pc = np.asarray(segmented_pulse_compression(
            jnp.asarray(echo, jnp.complex64), profile,
            reference_pulses(profile),
        ))
        outputs.append(plot_pc_animation(
            pc, save_path=os.path.join(args.output, "pc_anim.gif"),
            step=args.animate_step, max_frames=args.animate_frames,
        ))
    log.info("wrote %s (profile %s, meta %s)", outputs, profile.name, meta)
    for o in outputs:
        print(o)
    return 0


def cmd_dmx(args) -> int:
    """G0 end-to-end chain over a G1-format capture (DMX driver, D3).

    Replicates ``DMX_SignalProcessing_main_xzr.m``: per frame, read the
    dual-beam 24-bit capture, run PC -> MTD -> CFAR -> measurement, emit the
    per-frame estimate series; optionally compare against a GPS track.
    """
    import jax

    from radar_signal_process_tpu.config import G0ChainConfig, G0_PROFILE
    from radar_signal_process_tpu.ingest.packets import G1FrameReader
    from radar_signal_process_tpu.models.g0_chain import G0Chain

    profile = G0_PROFILE
    # None = agile: derive freq/beam from each frame's own parsed header, as
    # the reference does inside its loop (DMX_SignalProcessing_main_xzr.m:
    # 310-315, 506-516); an explicit flag pins the value for every frame.
    chain = G0Chain(
        profile, G0ChainConfig(),
        5 if args.freq_index is None else args.freq_index,
        0 if args.beam_pos is None else args.beam_pos,
        spectral_width_db=args.spectral_width_db,
        spectral_width_interp=args.spectral_width_interp,
    )
    reader_cls = G1FrameReader
    if args.native:
        from radar_signal_process_tpu.ingest import native_available
        from radar_signal_process_tpu.ingest.native_loader import (
            NativeG1FrameReader,
        )

        if native_available():
            reader_cls = NativeG1FrameReader
    reader = reader_cls(
        args.input,
        prt_num=profile.prt_per_frame,
        point_prt=profile.point_prt,
        frames_per_file=args.frames_per_file,
    )
    timers = StageTimers()
    frames_out = []
    for frame_idx in range(args.frame_start, args.frame_start + args.frames):
        with timers.stage("read"):
            left, right, angles, meta = reader.read_frame(frame_idx)
        fi = args.freq_index if args.freq_index is not None else int(
            meta.get("freq_index", chain.freq_index)
        )
        bp = args.beam_pos if args.beam_pos is not None else int(
            meta.get("beam_pos", chain.beam_pos)
        )
        with timers.stage("process") as h:
            res = chain.process_frame(left, right, freq_index=fi, beam_pos=bp)
            h["fence"] = res.flags_long
        angle = float(chain.compensate_angle(angles[:1])[0])
        entry = {
            "frame": frame_idx, "azimuth_deg": angle,
            "freq_index": fi, "beam_pos": bp,
        }
        for name, meas in (("short", res.measurements_short),
                           ("long", res.measurements_long)):
            valid = np.asarray(meas.valid)
            entry[name] = {
                "range_m": np.asarray(meas.range_m)[valid].tolist(),
                "velocity_ms": np.asarray(meas.velocity_ms)[valid].tolist(),
                "elevation_deg": np.asarray(meas.elevation_deg)[valid].tolist(),
            }
            if meas.spectral_width is not None:
                entry[name]["spectral_width_bins"] = np.asarray(
                    meas.spectral_width
                )[valid].tolist()
        frames_out.append(entry)
    out = {"frames": frames_out}
    gps_overlay = None

    if args.gps:
        from radar_signal_process_tpu.evalx.gps import (
            compare_estimates,
            drop_invalid,
            gps_frame_indices,
            read_gps_track,
        )

        track = read_gps_track(args.gps, start_line=args.gps_start_line)
        gi = gps_frame_indices(
            track, profile.prt, profile.prt_per_frame, args.frames_shift
        )
        track, gi = drop_invalid(track, gi)
        fr = np.asarray([
            f["frame"] for f in frames_out for _ in f["long"]["range_m"]
        ], dtype=np.float64)
        rr = np.asarray([
            r for f in frames_out for r in f["long"]["range_m"]
        ])
        out["gps_range_residuals"] = compare_estimates(fr, rr, gi, track.range_m)
        vv = np.asarray([
            v for f in frames_out for v in f["long"]["velocity_ms"]
        ])
        # the reference overlays velocity too (:592-599)
        out["gps_velocity_residuals"] = compare_estimates(
            fr, vv, gi, track.velocity_ms
        )
        gps_overlay = (gi, track.range_m, track.velocity_ms)

    if args.plots:
        # estimate-series scatter with GPS overlay, the reference's live
        # result plots (DMX_SignalProcessing_main_xzr.m:534-559,592-599)
        import os

        from radar_signal_process_tpu.viz import plot_estimate_series

        os.makedirs(args.plots, exist_ok=True)
        out["plots"] = {}
        for name in ("short", "long"):
            fr = np.asarray([
                f["frame"] for f in frames_out for _ in f[name]["range_m"]
            ], dtype=np.float64)
            path = plot_estimate_series(
                fr,
                np.asarray([r for f in frames_out for r in f[name]["range_m"]]),
                np.asarray([v for f in frames_out
                            for v in f[name]["velocity_ms"]]),
                np.asarray([e for f in frames_out
                            for e in f[name]["elevation_deg"]]),
                gps_frames=gps_overlay[0] if gps_overlay else None,
                gps_range_m=gps_overlay[1] if gps_overlay else None,
                gps_velocity_ms=gps_overlay[2] if gps_overlay else None,
                save_path=os.path.join(args.plots, f"estimates_{name}.png"),
                title=f"G0 estimate series ({name} pulse)",
            )
            out["plots"][name] = path

    if args.save_results:
        # result-struct persistence with full config echo, the reference's
        # resultData_<clock>.mat save (DMX_SignalProcessing_main_xzr.m:603-612)
        import dataclasses as dc
        import os
        import time as _time

        import scipy.io as sio

        def _series(key, name):
            return np.asarray(
                [x for f in frames_out for x in f[name][key]], dtype=np.float64
            )

        def _frames(name):
            return np.asarray(
                [f["frame"] for f in frames_out for _ in f[name]["range_m"]],
                dtype=np.float64,
            )

        payload = {
            "orgDataFilePath": args.input,
            "frameS": float(args.frame_start),
            "frameE": float(args.frame_start + args.frames - 1),
            "framesProcessTotal": float(args.frames),
            "freqInd": float(frames_out[0]["freq_index"]) if frames_out else -1.0,
            "beamPosNum": float(frames_out[0]["beam_pos"]) if frames_out else -1.0,
            "freqIndSeries": np.asarray(
                [f["freq_index"] for f in frames_out], dtype=np.float64
            ),
            "beamPosSeries": np.asarray(
                [f["beam_pos"] for f in frames_out], dtype=np.float64
            ),
            "angleCodeSeries": np.asarray(
                [f["azimuth_deg"] for f in frames_out], dtype=np.float64
            ),
            "resultEst_Struct": {
                name: {
                    "frame": _frames(name),
                    "rEst": _series("range_m", name),
                    "vEst": _series("velocity_ms", name),
                    "eleEst": _series("elevation_deg", name),
                }
                for name in ("short", "long")
            },
        }
        # config echo: every chain parameter, exactly as the reference saves
        # its winType/MTD_V/refCells/interp/sys-err knobs alongside results
        payload.update(
            {k: (v if isinstance(v, str) else float(v))
             for k, v in dc.asdict(chain.chain).items()}
        )
        os.makedirs(args.save_results, exist_ok=True)
        stamp = _time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(args.save_results, f"resultData_{stamp}.mat")
        sio.savemat(path, payload, do_compression=True)
        out["result_mat"] = path
        log.info("saved result struct to %s", path)

    print(json.dumps(out))
    log.info("dmx timing\n%s", timers.report())
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="radar_signal_process_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    sim = sub.add_parser("simulate", help="write a synthetic G2 .bin capture")
    sim.add_argument("--output", required=True)
    sim.add_argument("--profile", default="G2", choices=PROFILES)
    sim.add_argument("--frames", type=int, default=3)
    sim.add_argument("--velocity", type=float, default=-5.7)
    sim.add_argument("--range", type=float, default=320.0)
    sim.add_argument("--scr", type=float, default=10.0)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--file-bytes", type=int, default=0,
                     help="split the capture into files of this size")
    sim.set_defaults(fn=cmd_simulate)

    ing = sub.add_parser("ingest", help=".bin capture -> per-frame npz")
    ing.add_argument("--input", required=True)
    ing.add_argument("--output", required=True)
    ing.add_argument("--profile", default="G2", choices=PROFILES)
    ing.add_argument("--frames", type=int, default=10)
    ing.add_argument("--dbf-coeffs", default=None)
    ing.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    ing.add_argument("--max-retries", type=int, default=1000)
    ing.add_argument("--frames-per-file", type=int, default=10,
                     help="G1/G0 captures: frames per .bin file "
                          "(frameDataRead_A_xzr.m:34-41)")
    ing.add_argument("--debug-plots", default=None, metavar="DIR",
                     help="G1/G0: write Show_Read-style I/Q debug panels "
                          "per frame (Show_Read.m:127-136)")
    ing.add_argument("--format", default="npz", choices=("npz", "mat"),
                     help="artifact format; 'mat' writes the reference's "
                          "frame_N.mat bus (sig_data_DBF_allprts)")
    ing.add_argument("--force", action="store_true")
    ing.set_defaults(fn=cmd_ingest)

    mtd = sub.add_parser("mtd", help="frame npz -> windowed RDM npz")
    mtd.add_argument("--input", required=True)
    mtd.add_argument("--output", required=True)
    mtd.add_argument("--profile", default="G2", choices=PROFILES)
    mtd.add_argument("--frames", type=int, default=10)
    mtd.add_argument("--win-size", type=int, default=4)
    mtd.add_argument("--match-waveform", action="append", default=None,
                     metavar="SEG=PATH[:VAR]",
                     help="measured matched-filter waveform for chirped "
                          "segment SEG (0-based) from a .mat/.npz/.npy file "
                          "(fun_MTD_produce.m:72-78 hook); repeatable")
    mtd.add_argument("--istc", default=None, metavar="CURVE_TXT",
                     help="apply iSTC gain compensation from a "
                          "textread-style dB curve file (fun_iSTC.m:6-15)")
    mtd.add_argument("--format", default="npz", choices=("npz", "mat"),
                     help="'mat' writes MTD_win_all_beams cell arrays; "
                          "inputs auto-detect npz or mat")
    mtd.add_argument("--force", action="store_true")
    mtd.set_defaults(fn=cmd_mtd)

    det = sub.add_parser("detect", help="RDM npz -> CFAR flags + detections")
    det.add_argument("--input", required=True)
    det.add_argument("--output", required=True)
    det.add_argument("--profile", default="G2", choices=PROFILES)
    det.add_argument("--frames", type=int, default=10)
    det.add_argument("--threshold", type=float, default=5.0)
    det.add_argument("--thresholds", type=float, nargs="+", default=None,
                     help="sweep mode (main_cfar.m:40): one output dir per "
                          "threshold (npz: OUTPUT_T{t}; mat: the reference's "
                          "cfarFlag{win}_T{t} under OUTPUT), reference "
                          "levels computed once per frame")
    det.add_argument("--clutter-v", type=float, default=3.0)
    det.add_argument("--max-detections", type=int, default=64)
    det.add_argument("--spectral-width-db", type=float, default=None,
                     help="also record each detection's Doppler spectral "
                          "width at this dB constraint (K12, "
                          "ampConstrWidthEst.m)")
    det.add_argument("--spectral-width-interp", type=int, default=1,
                     help="spline-upsample factor for sub-bin widths (the "
                          "reference's interpFlag/interpTimes mode; 1 = off)")
    det.add_argument("--format", default="npz", choices=("npz", "mat"),
                     help="'mat' writes cfarFlag_win_{beam} variables; "
                          "inputs auto-detect npz or mat")
    det.add_argument("--force", action="store_true")
    det.set_defaults(fn=cmd_detect)

    e2e = sub.add_parser("e2e", help=".bin capture -> detection JSON, in memory")
    e2e.add_argument("--input", required=True)
    e2e.add_argument("--profile", default="G2", choices=PROFILES)
    e2e.add_argument("--frames", type=int, default=3)
    e2e.add_argument("--win-size", type=int, default=4)
    e2e.add_argument("--beam", type=int, default=0)
    e2e.add_argument("--win-slice", type=int, default=0)
    e2e.add_argument("--clutter-v", type=float, default=3.0)
    e2e.add_argument("--max-detections", type=int, default=16)
    e2e.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    e2e.add_argument("--mesh", default=None, metavar="DPxSP",
                     help="run the window over a (dp, sp) device mesh, e.g. "
                          "1x4: beams data-parallel, range sharded with "
                          "halo-exchange CFAR")
    e2e.set_defaults(fn=cmd_e2e)

    st = sub.add_parser("stream", help="streaming chain: overlapped ingest + "
                                       "compute with all-beam detection")
    st.add_argument("--input", required=True)
    st.add_argument("--profile", default="G2", choices=PROFILES)
    st.add_argument("--frames", type=int, default=10)
    st.add_argument("--win-size", type=int, default=4)
    st.add_argument("--clutter-v", type=float, default=3.0)
    st.add_argument("--max-detections", type=int, default=16)
    st.add_argument("--dbf-coeffs", default=None)
    st.add_argument("--istc", default=None, metavar="CURVE_TXT",
                    help="iSTC gain compensation curve (fun_iSTC.m)")
    st.add_argument("--block-windows", type=int, default=6,
                    help="windows per pipelined CPU block (cross-window "
                         "overlap span; memory scales with it)")
    st.add_argument("--emit", default="full",
                    choices=("detections", "flags", "full"),
                    help="per-window emission: 'detections' skips the "
                         "RDM+flag stack materialization entirely (the "
                         "reference's stage 3 persists flags/detections, "
                         "not RDMs — main_cfar.m:82-97); detections and "
                         "hit counters are identical across modes")
    st.add_argument("--match-waveform", action="append", default=None,
                    metavar="SEG=PATH[:VAR]",
                    help="measured matched-filter waveform per chirped "
                         "segment (fun_MTD_produce.m:72-78 hook); repeatable")
    st.add_argument("--mesh", default=None, metavar="DPxSP",
                    help="stream over a (dp, sp) device mesh with the "
                         "compressed previous frame carried on device "
                         "(parallel.make_sharded_stream), e.g. 2x4")
    st.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    st.set_defaults(fn=cmd_stream)

    dmx = sub.add_parser("dmx", help="G0 end-to-end chain over a G1-format capture")
    dmx.add_argument("--input", required=True)
    dmx.add_argument("--frames", type=int, default=1)
    dmx.add_argument("--frame-start", type=int, default=1)
    dmx.add_argument("--frames-per-file", type=int, default=10)
    dmx.add_argument("--freq-index", type=int, default=None,
                     help="pin the frequency index; default: per-frame from "
                          "each frame's parsed freInd (agile)")
    dmx.add_argument("--beam-pos", type=int, default=None,
                     help="pin the beam position; default: per-frame from "
                          "each frame's parsed beamPosNum (agile)")
    dmx.add_argument("--spectral-width-db", type=float, default=None,
                     help="also record each detection's Doppler spectral "
                          "width at this dB constraint (K12, "
                          "ampConstrWidthEst.m)")
    dmx.add_argument("--spectral-width-interp", type=int, default=1,
                     help="spline-upsample factor for sub-bin widths (the "
                          "reference's interpFlag/interpTimes mode; 1 = off)")
    dmx.add_argument("--gps", default=None)
    dmx.add_argument("--gps-start-line", type=int, default=1)
    dmx.add_argument("--frames-shift", type=int, default=0)
    dmx.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    dmx.add_argument("--plots", default=None, metavar="DIR",
                     help="write estimate-series plots (R/V/elevation vs "
                          "frame, GPS overlay when --gps is given)")
    dmx.add_argument("--save-results", default=None, metavar="DIR",
                     help="write resultData_<clock>.mat with the full config "
                          "echo (DMX_SignalProcessing_main_xzr.m:603-612)")
    dmx.set_defaults(fn=cmd_dmx)

    ana = sub.add_parser("analyze", help="render RDM dashboards from manifests")
    ana.add_argument("--input", required=True)
    ana.add_argument("--output", required=True)
    ana.add_argument("--profile", default="G2", choices=PROFILES)
    ana.add_argument("--frame", type=int, default=0)
    ana.add_argument("--beam", type=int, default=0)
    ana.add_argument("--win-slice", type=int, default=0)
    ana.add_argument("--animate", default=None,
                     choices=("pc", "doppler", "all"),
                     help="also write the reference's V1 animation modes "
                          "(fun_plot_visualizations.m:33-63) as .gif")
    ana.add_argument("--animate-step", type=int, default=8,
                     help="PRT/range-bin stride between animation frames")
    ana.add_argument("--animate-frames", type=int, default=24,
                     help="max animation frames")
    ana.add_argument("--stage1-input", default=None, metavar="DIR",
                     help="stage-1 frame dir for --animate pc")
    ana.set_defaults(fn=cmd_analyze)

    sw = sub.add_parser("sweep", help="threshold x SCR detection-metric sweep")
    sw.add_argument("--profile", default="G2", choices=PROFILES)
    sw.add_argument("--thresholds", type=float, nargs="+", default=[3.0, 5.0, 7.0])
    sw.add_argument("--scr", type=float, nargs="+", default=[0.0, 10.0, 20.0])
    sw.add_argument("--velocity", type=float, default=-5.7)
    sw.add_argument("--range", type=float, default=320.0)
    sw.add_argument("--frames", type=int, default=4)
    sw.add_argument("--clutter-v", type=float, default=3.0)
    sw.set_defaults(fn=cmd_sweep)
    return p


def main(argv=None) -> int:
    from radar_signal_process_tpu.utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
