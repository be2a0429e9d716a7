"""End-to-end DMX CLI test: G1-format capture -> G0 chain -> measurements."""

import json

import numpy as np

import radar_signal_process_tpu.cli as cli
from radar_signal_process_tpu.config import G0_PROFILE, G0ChainConfig
from radar_signal_process_tpu.models.g0_chain import G0Chain
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu.sim.packets_synth import write_g1_capture


def _g0_capture(tmp_path, rng, fd, cell_long):
    prof = G0_PROFILE
    n = prof.prt_per_frame
    p_short, p_long = reference_pulses(prof)
    m = np.arange(n)
    ramp = np.exp(1j * 2 * np.pi * fd * m * prof.prt)
    base = np.zeros((n, prof.point_prt), dtype=np.complex128)
    s0, s1 = prof.segment_starts
    base[:, s0 + 20 : s0 + 20 + len(p_short)] += ramp[:, None] * p_short[None, :]
    span = min(len(p_long), prof.segment_points[1] - cell_long)
    base[:, s1 + cell_long : s1 + cell_long + span] += ramp[:, None] * p_long[None, :span]
    noise = rng.standard_normal((2, n, prof.point_prt)) * 0.5
    scale = 5000.0
    left = np.round(scale * base.real + noise[0]) + 1j * np.round(scale * base.imag)
    right = np.round(0.8 * scale * base.real + noise[1]) + 1j * np.round(
        0.8 * scale * base.imag
    )
    write_g1_capture(
        str(tmp_path), left[None], right[None], frames_per_file=10, angle_deg=100.0
    )
    return prof


def test_dmx_cli_end_to_end(tmp_path, rng, capsys):
    prof = G0_PROFILE
    chain_cfg = G0ChainConfig()
    delta_dop = prof.prf / chain_cfg.mtd_fft_length
    fd = -60 * delta_dop
    cell_long = 100
    _g0_capture(tmp_path, rng, fd, cell_long)

    plots_dir = tmp_path / "plots"
    assert cli.main([
        "dmx", "--input", str(tmp_path), "--frames", "1",
        "--freq-index", "5", "--beam-pos", "2", "--plots", str(plots_dir),
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    # estimate-series plots written (DMX main :534-559)
    import os

    assert os.path.getsize(out["plots"]["long"]) > 1000
    assert os.path.getsize(out["plots"]["short"]) > 1000
    frame = out["frames"][0]
    # azimuth: 100 deg + north compensation (29.01 + 5.9)
    assert abs(frame["azimuth_deg"] - (100.0 + 29.01 + 5.9)) < 0.2

    chain = G0Chain(prof, chain_cfg, 5, 2)
    v_expected = -chain.wavelength * fd / 2.0
    r_expected = (
        cell_long * prof.delta_r
        + chain_cfg.r_sys_err_long
        - chain_cfg.r_measure_err_long
    )
    vels = frame["long"]["velocity_ms"]
    rngs = frame["long"]["range_m"]
    assert any(abs(v - v_expected) < 0.3 for v in vels), (vels, v_expected)
    assert any(abs(r - r_expected) < 2 * prof.delta_r for r in rngs)


def test_g0_chain_per_frame_agility(rng):
    """process_frame(freq_index=, beam_pos=) == a chain constructed fixed at
    those values — the traced per-frame parameters are bit-faithful
    (DMX_SignalProcessing_main_xzr.m:310-315,506-516)."""
    prof = G0_PROFILE
    cfg = G0ChainConfig()
    n = prof.prt_per_frame
    fd = -60 * prof.prf / cfg.mtd_fft_length
    p_short, p_long = reference_pulses(prof)
    m = np.arange(n)
    ramp = np.exp(1j * 2 * np.pi * fd * m * prof.prt)
    base = np.zeros((n, prof.point_prt), dtype=np.complex128)
    s0, s1 = prof.segment_starts
    base[:, s0 + 20 : s0 + 20 + len(p_short)] += ramp[:, None] * p_short[None, :]
    base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
    left = (5000.0 * base + rng.standard_normal((n, prof.point_prt))).astype(
        np.complex64
    )
    right = (0.8 * left).astype(np.complex64)

    agile = G0Chain(prof, cfg, freq_index=5, beam_pos=0)
    for fi, bp in ((0, 1), (10, 3)):
        got = agile.process_frame(left, right, freq_index=fi, beam_pos=bp)
        fixed = G0Chain(prof, cfg, freq_index=fi, beam_pos=bp)
        want = fixed.process_frame(left, right)
        for field in ("range_m", "velocity_ms", "elevation_deg", "valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got.measurements_long, field)),
                np.asarray(getattr(want.measurements_long, field)),
                err_msg=f"({fi},{bp}) {field}",
            )
        np.testing.assert_array_equal(
            np.asarray(got.flags_long), np.asarray(want.flags_long)
        )
        # the per-frame parameters actually differ from the defaults
        assert fixed.k_value != agile.k_value or fi == 5


def test_dmx_cli_freq_hop_capture(tmp_path, rng, capsys):
    """cli dmx with no --freq-index/--beam-pos derives both from each
    frame's own parsed header (agile mode)."""
    prof = G0_PROFILE
    cfg = G0ChainConfig()
    n = prof.prt_per_frame
    fd = -60 * prof.prf / cfg.mtd_fft_length
    p_short, p_long = reference_pulses(prof)
    ramp = np.exp(1j * 2 * np.pi * fd * np.arange(n) * prof.prt)
    base = np.zeros((n, prof.point_prt), dtype=np.complex128)
    s0, s1 = prof.segment_starts
    base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
    left = np.round(5000.0 * base.real) + 1j * np.round(5000.0 * base.imag)
    right = 0.8 * left
    write_g1_capture(
        str(tmp_path),
        np.stack([left, left]), np.stack([right, right]),
        freq_index=[2, 9], beam_pos=[1, 4],
    )

    assert cli.main(["dmx", "--input", str(tmp_path), "--frames", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [f["freq_index"] for f in out["frames"]] == [2, 9]
    assert [f["beam_pos"] for f in out["frames"]] == [1, 4]
    # same echo, different beam position -> elevation estimates shift by
    # ~ (4-1)*beam_angle_step plus the K-value-difference term
    e1 = out["frames"][0]["long"]["elevation_deg"]
    e2 = out["frames"][1]["long"]["elevation_deg"]
    assert e1 and e2
    shift = e2[0] - e1[0]
    assert abs(shift - 3 * cfg.beam_angle_step) < 3.0, shift


def test_dmx_cli_save_results(tmp_path, rng, capsys):
    """--save-results writes resultData_<clock>.mat with the config echo
    (DMX_SignalProcessing_main_xzr.m:603-612)."""
    import scipy.io as sio

    prof = G0_PROFILE
    chain_cfg = G0ChainConfig()
    fd = -60 * prof.prf / chain_cfg.mtd_fft_length
    _g0_capture(tmp_path, rng, fd, 100)
    results_dir = tmp_path / "results"

    assert cli.main([
        "dmx", "--input", str(tmp_path), "--frames", "1",
        "--freq-index", "5", "--beam-pos", "2",
        "--save-results", str(results_dir),
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    m = sio.loadmat(out["result_mat"], squeeze_me=True)
    # config echo present (window type, CFAR-era knobs, interp factors)
    assert m["pc_window"] == "kaiser"
    assert m["mtd_fft_length"] == chain_cfg.mtd_fft_length
    assert m["r_interp_times"] == chain_cfg.r_interp_times
    assert str(m["orgDataFilePath"]) == str(tmp_path)
    # estimate series match the JSON output
    est = m["resultEst_Struct"]["long"].item()
    vels = np.atleast_1d(est["vEst"].item())
    assert sorted(np.round(vels, 6)) == sorted(
        np.round(out["frames"][0]["long"]["velocity_ms"], 6).tolist()
    )


def test_dmx_cli_gps_overlay(tmp_path, rng, capsys):
    """--gps reports range AND velocity residuals vs the interpolated
    differential-GPS track (DMX_SignalProcessing_main_xzr.m:567-601)."""
    prof = G0_PROFILE
    chain_cfg = G0ChainConfig()
    delta_dop = prof.prf / chain_cfg.mtd_fft_length
    fd = -60 * delta_dop
    cell_long = 100
    _g0_capture(tmp_path, rng, fd, cell_long)

    chain = G0Chain(prof, chain_cfg, 5, 2)
    v_expected = -chain.wavelength * fd / 2.0
    r_expected = (
        cell_long * prof.delta_r
        + chain_cfg.r_sys_err_long
        - chain_cfg.r_measure_err_long
    )
    # 5-column track (time, range, velocity, azimuth, height) covering
    # radar frames 0..2 with the truth at every sample
    t_frame = prof.prt * prof.prt_per_frame
    gps = tmp_path / "gps.txt"
    gps.write_text("".join(
        f"{i * t_frame:.6f} {r_expected:.3f} {v_expected:.4f} 100.0 50.0\n"
        for i in range(3)
    ))

    assert cli.main([
        "dmx", "--input", str(tmp_path), "--frames", "1",
        "--freq-index", "5", "--beam-pos", "2",
        "--gps", str(gps), "--gps-start-line", "1",
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    rr = out["gps_range_residuals"]
    vr = out["gps_velocity_residuals"]
    assert rr["n"] >= 1 and vr["n"] >= 1
    assert rr["rmse"] < 2 * prof.delta_r, rr
    assert vr["rmse"] < 0.3, vr


def test_g0_chain_rejects_out_of_table_indices():
    """Corrupt header freq/beam indices must fail loud, not wrap into the
    wrong calibration-table row (negative numpy indexing is silent)."""
    import pytest

    chain = G0Chain(G0_PROFILE, G0ChainConfig())
    for fi, bp in ((-1, 0), (11, 0), (0, 12), (99, 99)):
        with pytest.raises(ValueError, match="calibration tables"):
            chain.frame_params(fi, bp)


def test_dmx_cli_spectral_width(tmp_path, rng, capsys):
    """--spectral-width-db surfaces K12 per-detection Doppler widths."""
    prof = G0_PROFILE
    chain_cfg = G0ChainConfig()
    fd = -60 * prof.prf / chain_cfg.mtd_fft_length
    _g0_capture(tmp_path, rng, fd, 100)
    assert cli.main([
        "dmx", "--input", str(tmp_path), "--frames", "1",
        "--freq-index", "5", "--beam-pos", "2",
        "--spectral-width-db", "-10.0",
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    frame = out["frames"][0]
    widths = frame["long"]["spectral_width_bins"]
    assert len(widths) == len(frame["long"]["range_m"])
    assert all(w >= 0.0 for w in widths)
    # the injected single-Doppler-line target has a narrow width; a notched
    # column can never fill the whole axis
    assert max(widths) < chain_cfg.mtd_fft_length / 2

