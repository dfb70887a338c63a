"""Multi-host orchestration (SURVEY.md SS5.8).

A multi-host run is: ``init_distributed()`` on every host, one global
(data, seq) mesh over all chips, per-host file shards feeding the local
devices (``ingest.shard_files``), and the same ``dist_scan`` collectives —
XLA lowers psum/ppermute to the platform's collectives (NCCL on GPUs),
within a host and across hosts.

This module is structured so single-host == multi-host with host_count=1;
real multi-host execution requires several hosts (validated here on the
virtual device mesh, SURVEY.md SS4.4).
"""

from __future__ import annotations

import dataclasses
import os

import jax

from .mesh import make_mesh

__all__ = ["HostTopology", "init_distributed", "global_mesh"]


@dataclasses.dataclass(frozen=True)
class HostTopology:
    host_index: int
    host_count: int
    local_devices: int
    global_devices: int


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> HostTopology:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Safe no-op for single-process runs."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0")
    )
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return HostTopology(
        host_index=process_id,
        host_count=num_processes,
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )


def global_mesh(n_seq: int = 1):
    """(data, seq) mesh over every device of every host."""
    return make_mesh(n_seq=n_seq)
