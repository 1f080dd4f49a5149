"""Active-mesh context: lets the API layer select data parallelism once.

Every heavy reference function takes ``BPPARAM`` (R/adaptorAlign.R:8,
R/tuneAlignment.R:8, R/getAdaptorThresholds.R:6, R/barcodeAlign.R:4,
R/qualityAlign.R:4, R/multiReadAlign.R:7, R/extractSubseq.R:5); the device
equivalent is a ``jax.sharding.Mesh`` accepted by each API function.  The
kernels they reach are all batch-parallel, so sharding is one decision —
"place batch-major arrays with the leading axis split over the mesh" — made
here once and consulted by the op layer's :func:`shard_batch` at every
device upload.  XLA then partitions each kernel SPMD with no collectives
(the workload is share-nothing over reads/pairs/groups, matching the
reference's BiocParallel model).
"""

from __future__ import annotations

import contextlib
import contextvars

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "sarlacc_active_mesh", default=None
)

__all__ = ["use_mesh", "active_mesh", "mesh_size", "shard_batch", "pad_to_mesh"]


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` (or no-op when None) for the enclosed block."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


def mesh_size(mesh=None) -> int:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    import numpy as np

    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def pad_to_mesh(n: int, mesh=None) -> int:
    """Round a batch size up to a multiple of the active mesh size."""
    m = mesh_size(mesh)
    return ((n + m - 1) // m) * m


def shard_batch(*arrays):
    """device_put batch-major arrays with the leading axis split over the
    active mesh.  No active mesh (or a non-divisible leading axis, which the
    power-of-two bucketing normally prevents) leaves the arrays untouched —
    correctness never depends on sharding.
    """
    mesh = active_mesh()
    if mesh is None:
        return arrays if len(arrays) != 1 else arrays[0]
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    m = mesh_size(mesh)
    spec = NamedSharding(mesh, P(mesh.axis_names[0]))
    out = tuple(
        jax.device_put(a, spec) if (hasattr(a, "shape") and a.shape and a.shape[0] % m == 0) else a
        for a in arrays
    )
    return out if len(out) != 1 else out[0]
