"""Two-process ``jax.distributed`` CPU test: the first real cross-process
execution of the DCN scale-out path (``parallel/multihost.py``; SURVEY.md
§5.8).  Spawns two worker processes, each with 2 virtual CPU devices, that
form a 4-device global ``dp`` mesh, run the dp-sharded radar chain, and
reduce to a replicated scalar; parity is asserted against the unsharded
single-process chain.

CI-safe: skipped if the workers cannot rendezvous within the timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dp_mesh_matches_single_process(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.pathsep.join(
            p for p in (
                os.path.dirname(os.path.dirname(os.path.abspath(_WORKER))),
                env.get("PYTHONPATH", ""),
            ) if p
        ),
    )
    outs = [str(tmp_path / f"proc{i}.json") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), coordinator, outs[i]],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.skip("jax.distributed workers did not finish in time")
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode != 0 for p in procs):
        # distinguish environment limitations (no loopback rendezvous /
        # missing collective transport) from real logic failures
        blob = "\n".join(logs)
        for marker in ("DEADLINE_EXCEEDED", "UNAVAILABLE", "barrier timed out"):
            if marker in blob:
                pytest.skip(f"distributed rendezvous unavailable: {marker}")
        raise AssertionError(f"worker failed:\n{blob[-4000:]}")

    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    assert {r["process_id"] for r in results} == {0, 1}
    assert all(r["num_processes"] == 2 for r in results)
    assert all(r["n_devices"] == 4 for r in results)
    # both processes computed the same replicated reduction
    assert results[0]["flag_sum"] == results[1]["flag_sum"]
    np.testing.assert_allclose(
        results[0]["rdm_sum"], results[1]["rdm_sum"], rtol=1e-6
    )
    # phase 2: halo-exchange (dp=2, sp=2) pipeline — its sp collectives
    # crossed the process boundary; flags are bit-identical to the
    # unsharded detect chain, so the counts must agree exactly
    assert results[0]["halo_flag_sum"] == results[1]["halo_flag_sum"]
    assert results[0]["halo_flag_sum"] == results[0]["flag_sum"]
    np.testing.assert_allclose(
        results[0]["halo_rdm_sum"], results[0]["rdm_sum"], rtol=1e-5
    )

    # phase 3: the streaming carry crossed the process boundary twice; both
    # processes saw identical window flag counts
    assert results[0]["stream_flag_sums"] == results[1]["stream_flag_sums"]
    assert len(results[0]["stream_flag_sums"]) == 2

    # parity vs the unsharded single-process chain on the same batch
    sys.path.insert(0, os.path.dirname(_WORKER))
    from distributed_worker import chain_sums, make_batch, tiny_profile

    import jax
    import jax.numpy as jnp

    want = np.asarray(
        jax.jit(lambda x: chain_sums(x, tiny_profile()))(
            jnp.asarray(make_batch())
        )
    )
    assert results[0]["flag_sum"] == want[1]
    np.testing.assert_allclose(results[0]["rdm_sum"], want[0], rtol=1e-5)

    # and the streamed windows match the single-process host streaming
    # chain's detect counts on the same frames
    from radar_signal_process_tpu.models.host_parallel import (
        make_cpu_flags,
        make_cpu_stream_processor,
    )

    prof = tiny_profile()
    rng = np.random.default_rng(7)
    fshape = (2, prof.prt_per_frame, prof.point_prt)
    frames = [
        (rng.standard_normal(fshape) + 1j * rng.standard_normal(fshape))
        .astype(np.complex64)
        for _ in range(3)
    ]
    host = make_cpu_stream_processor(prof, 4)
    flags_fn = make_cpu_flags(prof, 4)
    for w in range(2):
        rdms = host(frames[w], frames[w + 1], frame_idx=w)
        flags, _ = flags_fn(rdms)
        assert results[0]["stream_flag_sums"][w] == float(flags.sum()), w
