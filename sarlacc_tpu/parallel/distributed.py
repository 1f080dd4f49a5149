"""Multi-host bootstrap — the BiocParallel multi-machine analog.

The reference's parallel layer explicitly accommodates multi-machine
backends (SnowParam/BatchtoolsParam, /root/reference/R/adaptorAlign.R:127-129
and DESCRIPTION:12); the device equivalent (SURVEY.md §5.8, §7.2(7)) is
``jax.distributed`` + a global device mesh + host-sharded FASTQ input:

1. every host calls :func:`init_distributed` (coordinator address via args
   or ``SARLACC_COORDINATOR``/``SARLACC_NUM_PROCS``/``SARLACC_PROC_ID`` env,
   mirroring how cluster launchers inject rank info);
2. each host streams ONLY its byte range of the FASTQ
   (``io.fastq.stream_fastq(..., shard=host_shard())``) — rank-ordered
   shard streams tile the file record-for-record;
3. batches become global arrays with
   :func:`jax.make_array_from_process_local_data` over the global mesh
   (:func:`global_mesh`), and the existing shard_map collectives
   (``parallel.mesh``) run unchanged — psum histograms cross devices and
   hosts instead of the driver-side concatenation;
4. results that must be host-complete (grouping, MSA strings) come back
   through the deterministic shuffle/merge in ``parallel.shuffle`` whose
   output is byte-identical to the single-host run (tests/test_distributed.py
   proves this with two real CPU processes).

On CPU test rigs, set ``JAX_CPU_COLLECTIVES_IMPLEMENTATION=gloo`` (process
env, before JAX loads) so cross-process CPU collectives are available.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "init_distributed",
    "is_distributed",
    "host_shard",
    "global_mesh",
    "host_local_batch_to_global",
]

_INITIALIZED = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialize ``jax.distributed`` once; returns (process_id, n_processes).

    Arguments fall back to ``SARLACC_COORDINATOR`` / ``SARLACC_NUM_PROCS`` /
    ``SARLACC_PROC_ID``.  Single-process runs (nothing configured) skip
    initialization entirely and report (0, 1).
    """
    global _INITIALIZED
    import jax

    coordinator_address = coordinator_address or os.environ.get("SARLACC_COORDINATOR")
    if num_processes is None and "SARLACC_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["SARLACC_NUM_PROCS"])
    if process_id is None and "SARLACC_PROC_ID" in os.environ:
        process_id = int(os.environ["SARLACC_PROC_ID"])

    if not _INITIALIZED:
        if coordinator_address is not None or num_processes is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            _INITIALIZED = True
    return jax.process_index(), jax.process_count()


def is_distributed() -> bool:
    import jax

    return jax.process_count() > 1


def host_shard() -> tuple[int, int]:
    """(rank, nshards) for host-sharded IO — feed to ``stream_fastq(shard=)``."""
    import jax

    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "reads"):
    """1-D mesh over ALL global devices (every host's chips)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def common_local_rows(n_local: int) -> int:
    """Smallest row count >= every host's local batch that is a multiple of
    the local device count — hosts must agree on one local shard shape
    before a global array can be assembled, so the sizes are exchanged
    through the coordination service (one tiny allgather)."""
    import jax

    n_dev = max(len(jax.local_devices()), 1)
    if jax.process_count() == 1:
        mx = n_local
    else:
        from jax.experimental import multihost_utils

        sizes = multihost_utils.process_allgather(np.asarray([n_local]))
        mx = int(np.max(sizes))
    return max(((mx + n_dev - 1) // n_dev) * n_dev, n_dev)


def host_local_batch_to_global(mesh, *arrays, axis: str = "reads"):
    """Per-host batch-major arrays -> global jax.Arrays sharded on ``axis``.

    Each host contributes its local rows (already padded to the SAME row
    count everywhere — see :func:`common_local_rows`); together they form
    one global batch without any cross-host data movement — the global
    array is an addressing construct over in-place shards.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return tuple(
        jax.make_array_from_process_local_data(sharding, np.asarray(a))
        for a in arrays
    )
