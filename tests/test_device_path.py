"""The GPU device path, checked on the CPU.

The card itself is reached only by ``chip_smoke.py`` and ``tests/test_gpu.py``.
Here: the compile-cache helper, ``chip_smoke.py``'s phases at reduced
geometry, the dispatch the GPU takes (``jax.default_backend`` patched to
``"gpu"``), the ``HIGHEST`` precision sites, and the windowed device stream
against the oracle.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke
from radar_signal_process_tpu import config
from radar_signal_process_tpu.config import (
    G0_PROFILE,
    G1_PROFILE,
    G2_PROFILE,
    NARROW_PULSE_FIR_TAPS,
)
from radar_signal_process_tpu.utils import compile_cache
from tests.oracle import dsp as oracle_dsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# G2 cut to a CPU-test size: 3 of 13 beams, 48 PRTs, shorter pulses and
# segments; 16 channels, the target at 320 m in the long segment
TINY_G2 = dataclasses.replace(
    G2_PROFILE, prt_per_frame=48, pulse_widths=(0.16e-6, 2e-6, 4e-6),
    point_prt=460, segment_points=(40, 120, 300), n_beams=3,
    cfar_segments=((0, 40), (40, 160), (160, 460)),
)


@pytest.fixture
def on_gpu_dispatch(monkeypatch):
    """Take the branches the GPU takes."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.fixture
def tiny_g2(monkeypatch):
    monkeypatch.setitem(config.PROFILES, "G2", TINY_G2)
    return TINY_G2


# ------------------------------------------------------------ compile cache
def test_compile_cache_uses_the_environment_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("tmpdir_env", ["/var/tmp/other", ""])
def test_compile_cache_path_is_fixed(monkeypatch, tmpdir_env):
    """Never a temporary name, a process id or a time: the same path in
    every process, whatever TMPDIR says."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", tmpdir_env)
    path = compile_cache.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in path
    assert not path.startswith(tempfile.gettempdir() + os.sep)


def test_compile_cache_lands_in_the_environment_directory(tmp_path):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from radar_signal_process_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "print(jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).sum())\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"),
               PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path), timeout=120, capture_output=True)
    assert os.listdir(tmp_path / "cc")


def test_compile_cache_directory_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


# ------------------------------------------------------------ chip_smoke.py
def test_chip_smoke_refuses_the_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_g2_phase_at_reduced_geometry(tiny_g2, on_gpu_dispatch,
                                                  tmp_path):
    out = chip_smoke.phase_g2(str(tmp_path), seed=0)
    assert out["windows"] == 4
    for p in out["parity"]:
        assert p["rdm_err"] <= chip_smoke.RDM_BOUND
        assert p["flag_cells"] > 0


def test_chip_smoke_four_phase_on_four_devices(tiny_g2, on_gpu_dispatch,
                                               tmp_path):
    out = chip_smoke.phase_four(str(tmp_path), seed=1)
    for mesh in ("1x4", "2x2"):
        assert out[mesh]["devices"] == [0, 1, 2, 3]
        assert out[mesh]["rdm_err"] <= chip_smoke.RDM_BOUND


def test_chip_smoke_g0_phase(on_gpu_dispatch, tmp_path):
    out = chip_smoke.phase_g0(str(tmp_path), seed=0, n_frames=2)
    assert out["compiles"][0] > 0 and out["compiles"][1] == 0
    assert set(out["forms"]) == {"one_executable", "split"}


def test_chip_smoke_stage_times(tiny_g2):
    out = chip_smoke.stage_times(repeats=2)
    assert set(out) == {"pulse_compression", "doppler_mag_notch",
                        "cfar_cascade", "extraction"}
    assert all(r["ms"] > 0 and r["min_gb"] > 0 for r in out.values())


def test_chip_smoke_dbf_coefficients_steer_the_echo(tmp_path):
    from radar_signal_process_tpu.ops.dbf import load_dbf_coeffs

    path = str(tmp_path / "dbf.txt")
    beam = chip_smoke.write_dbf_coeffs(path, 13, 16)
    w = load_dbf_coeffs(path, 16)
    assert w.shape == (13, 16) and beam == 6
    echo = np.exp(1j * 2 * np.pi * np.arange(16) / 64.0)   # cli simulate
    gain = np.abs(w @ echo)
    assert gain[beam] == pytest.approx(1.0)
    assert np.all(np.delete(gain, beam) < 10 ** (-10 / 20))


@pytest.mark.parametrize("where", ["far", "near"])
def test_chip_smoke_flag_comparison_allows_only_near_threshold(rng, where):
    prof = dataclasses.replace(TINY_G2, cfar_segments=())
    rdm = np.abs(rng.standard_normal((48, 120))) + 0.1
    rdm[20, 60] = 40.0
    flags, near = chip_smoke.oracle_flags(rdm, prof, 2)
    chip = flags.copy()
    if where == "far":
        cell = tuple(np.argwhere(~near)[0])
        chip[cell] = ~chip[cell]
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.compare_flags(chip, flags, near, "test")
    else:
        near = np.zeros_like(near)
        near[5, 7] = True
        chip[5, 7] = ~chip[5, 7]
        assert chip_smoke.compare_flags(chip, flags, near, "test") == 1


# ------------------------------------------------------- GPU-side dispatch
@pytest.mark.parametrize("conv_len", [3404 + 699, 723 + 199, 60 + 34])
def test_fft_len_is_one_rule_on_every_backend(monkeypatch, conv_len):
    from radar_signal_process_tpu.ops.pulse_compression import (
        _fft_len,
        _next_5smooth,
    )

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    n = _fft_len(conv_len)
    assert n == _next_5smooth(conv_len) >= conv_len
    m = n
    for p in (2, 3, 5):
        while m % p == 0:
            m //= p
    assert m == 1


def test_doppler_process_is_the_fft_on_gpu(on_gpu_dispatch, rng):
    from radar_signal_process_tpu.ops.mtd import doppler_process
    from radar_signal_process_tpu.ops.windows import make_window

    pc = rng.standard_normal((2, 332, 24)) + 1j * rng.standard_normal((2, 332, 24))
    w = make_window("kaiser", 332, 8.0)
    got = np.asarray(doppler_process(jnp.asarray(pc), w))
    want = np.abs(np.fft.fftshift(np.fft.fft(pc * w[:, None], axis=-2), axes=-2))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_detect_rdm_on_gpu_matches_oracle(on_gpu_dispatch, rng):
    from radar_signal_process_tpu.models.detect import detect_rdm

    prof = dataclasses.replace(TINY_G2, cfar_segments=((0, 50), (50, 120)))
    rdm = np.abs(rng.standard_normal((48, 120))) + 0.1
    rdm[30, 80] += 60.0
    flags, _ = detect_rdm(jnp.asarray(rdm), prof, 2)
    want, _ = chip_smoke.oracle_flags(rdm, prof, 2)
    np.testing.assert_array_equal(np.asarray(flags), want)
    assert want[30, 80]


@pytest.mark.parametrize("backend,split", [("gpu", False), ("cpu", True)])
def test_g0_chain_default_form(monkeypatch, backend, split):
    from radar_signal_process_tpu.models.g0_chain import G0Chain

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert G0Chain()._use_split is split


@pytest.mark.parametrize("backend,windowed", [("gpu", True), ("cpu", False)])
def test_streaming_consumer_per_backend(monkeypatch, backend, windowed):
    from radar_signal_process_tpu.models.streaming import StreamingPipeline

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    pipe = StreamingPipeline(reader=None, profile=TINY_G2)
    assert (pipe._block_runner is None) is windowed


# ------------------------------------------------------------ precision
def _precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _motion(rdm):
    from radar_signal_process_tpu.ops.measure import (
        extract_detections,
        motion_parameters,
    )

    dets = extract_detections(rdm > 2.0, rdm, 4)
    return motion_parameters(
        rdm, rdm * 0.1, dets, r_scale=np.arange(rdm.shape[1]) * 6.0,
        delta_r=6.0, v_scale=np.linspace(-5, 5, rdm.shape[0]), delta_v=0.1,
        k_value=1.0, beam_pos=0, beam_angle_step=5.0, n_clutter=2,
    ).range_m


@pytest.mark.parametrize("site", ["apply_dbf", "spline_interp_notaknot",
                                  "motion_parameters"])
def test_product_sites_ask_for_highest_precision(site):
    from radar_signal_process_tpu.ops.dbf import apply_dbf
    from radar_signal_process_tpu.ops.measure import spline_interp_notaknot

    if site == "apply_dbf":
        precs = _precisions(lambda x: apply_dbf(x, np.ones((13, 16), np.complex64)),
                            jnp.ones((4, 8, 16), jnp.complex64))
    elif site == "spline_interp_notaknot":
        precs = _precisions(lambda y: spline_interp_notaknot(y, 4),
                            jnp.ones((3, 5), jnp.float32))
    else:
        precs = _precisions(_motion, jnp.ones((32, 40), jnp.float32) * 3.0)
    assert precs
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precs), precs


# -------------------------------------------- windowed device-path stream
def _oracle_pc(echo, prof):
    """Per-PRT segmented compression for any segment layout."""
    from radar_signal_process_tpu.config import matlab_round
    from radar_signal_process_tpu.ops.waveforms import reference_pulses

    pulses = reference_pulses(prof)
    taps = np.asarray(NARROW_PULSE_FIR_TAPS, np.float64)
    b = taps / taps.max()
    delay = matlab_round((len(b) - 1) / 2.0)
    out = np.zeros(echo.shape, np.complex128)
    for i in range(echo.shape[0]):
        for k, (s, n) in enumerate(zip(prof.segment_starts, prof.segment_points)):
            x = echo[i, s : s + n]
            if prof.chirp_signs[k] == 0:
                out[i, s : s + n] = np.roll(
                    oracle_dsp.fir_filter_causal(b, x) / 1.2, -delay)
            else:
                full = oracle_dsp.matched_filter_full(pulses[k], x)
                m = len(pulses[k])
                out[i, s : s + n] = full[m - 1 : m - 1 + n]
    return out


REDUCED = {
    "G2": TINY_G2,
    "G1": dataclasses.replace(
        G1_PROFILE, prt_per_frame=40, pulse_widths=(0.28e-6, 1e-6, 2e-6),
        point_prt=200, segment_points=(30, 60, 110),
        cfar_segments=((0, 30), (30, 90), (90, 200)),
    ),
    "G0": dataclasses.replace(
        G0_PROFILE, prt_per_frame=48, pulse_widths=(0.56e-6, 2e-6),
        point_prt=160, segment_points=(40, 120),
        mtd=dataclasses.replace(G0_PROFILE.mtd, fft_length=64),
        cfar=dataclasses.replace(G0_PROFILE.cfar, ref_cells=3, guard_cells=2),
    ),
}


@pytest.mark.parametrize("name", ["G2", "G1", "G0"])
def test_windowed_device_stream_matches_oracle(on_gpu_dispatch, rng, name):
    """make_frame_processor + make_detector, the GPU's stream consumer, at
    reduced geometry against the loop oracle (RDM, then flags recomputed
    by the oracle from the returned RDM)."""
    from radar_signal_process_tpu.models.detect import clutter_cells, make_detector
    from radar_signal_process_tpu.models.mtd_pipeline import (
        make_frame_processor,
        window_slice_starts,
    )
    from radar_signal_process_tpu.ops.windows import make_window

    prof = REDUCED[name]
    n = prof.prt_per_frame
    shape = (2, 2, n, prof.point_prt)       # (frame, beam, prt, sample)
    a, b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    rdms = make_frame_processor(prof, 4)(jnp.asarray(a), jnp.asarray(b))
    n_fft = prof.mtd.fft_length or n
    n_clutter = clutter_cells(prof, n_fft)
    flags, _, dets = make_detector(prof, n_clutter=n_clutter)(rdms)
    assert rdms.shape == (2, 4, n_fft, prof.point_prt)

    window = make_window(prof.mtd.window, n, prof.mtd.window_beta)
    beam, s = 1, 2
    start = window_slice_starts(n, 4)[s]
    echo = np.concatenate([a[beam], b[beam]], axis=0)[start : start + n]
    pc = _oracle_pc(echo, prof)
    spec = np.fft.fft(pc * window[:, None], n_fft, axis=0)
    if prof.mtd.fftshift:
        spec = np.fft.fftshift(spec, axes=0)
    want = np.abs(spec)
    if prof.mtd.notch_divisor:
        want = oracle_dsp.zero_velocity_notch(want, prof.mtd.notch_divisor)
    got = np.asarray(rdms[beam, s])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7 * want.max())

    want_flags, _ = chip_smoke.oracle_flags(got, prof, n_clutter)
    np.testing.assert_array_equal(np.asarray(flags[beam, s]), want_flags)
    assert np.asarray(dets.valid).shape[:2] == (2, 4)


# ------------------------------------------------------------ leftovers
def test_no_module_uses_the_removed_pallas_backend():
    hits = []
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if not d.startswith(".") and d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    text = fh.read()
                if "pallas." "t" "pu" in text or "pl" "t" "pu" in text:
                    hits.append(os.path.relpath(path, REPO))
    assert hits == [], hits


def test_bench_has_no_cpu_fallback():
    import bench

    for name in ("_reexec_cpu", "_claim_backend", "timing_channel_works"):
        assert not hasattr(bench, name)


def test_bench_refuses_a_gpu_host_without_a_gpu(monkeypatch):
    import bench

    real = os.path.exists
    monkeypatch.setattr(os.path, "exists",
                        lambda p: p == "/dev/nvidiactl" or real(p))
    with pytest.raises(SystemExit):
        bench._require_gpu_on_gpu_host()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_bench_speed_of_light_only_on_the_cpu(monkeypatch, backend):
    import bench

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    pct = bench._sol_pct(1e9, 2e9, 0.5)
    assert (pct is None) is (backend == "gpu")
