"""Multi-host (DCN) scale-out helpers.

Intra-host parallelism rides device collectives (``sharding.py``); scaling
to multiple hosts uses ``jax.distributed`` + a global mesh whose ``dp`` axis
spans hosts (frames/beams are embarrassingly parallel across the network,
halo exchange stays within a host).  This module wires the standard
initialization and provides host-local frame assignment for the streaming pipeline.

There is no multi-host hardware in CI; the logic here is the documented
production path, with the single-process degenerate case tested.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import jax


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> Tuple[int, int]:
    """Initialize ``jax.distributed`` from args or the standard env vars.

    Returns ``(process_id, num_processes)``.  A no-op single-process setup
    when no coordinator is configured.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return 0, 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def host_frame_assignment(
    n_frames: int, process_id: int | None = None, num_processes: int | None = None
) -> Sequence[int]:
    """Contiguous frame ranges per host for data-parallel ingest.

    Frame pairs need one-frame overlap at the boundary (the doubled-CPI
    window pairs frame i with i+1), so each host's range extends one frame
    past its last owned frame.
    """
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    per = -(-n_frames // n)
    start = pid * per
    stop = min(n_frames, start + per)
    if stop < n_frames:
        stop += 1  # CPI-pair overlap
    return range(start, stop)
