"""Device-derived memory budgets for the MSA pipeline.

Budgets are fractions of the device memory that
``jax.devices()[0].memory_stats()`` reports at first use, with fixed
constants (2 GiB library table, 1 GiB segment window, 3 GiB pair-DP
in-flight window) as the fallback when the backend exposes no stats (CPU
tests).  The fractions were chosen on earlier hardware and have not yet
been measured on the GPU.

Probed once per process: the pipeline's own allocations must not shrink
later budgets mid-run (the windows are sized against the chip, not against
instantaneous free bytes).
"""

from __future__ import annotations

__all__ = ["device_memory_budget", "budget_report"]

_FREE_BYTES: int | None = None
_PROBED = False
_GIVEN: dict[str, int] = {}

#: Fixed reserve subtracted from the device's capacity: headroom for XLA
#: scratch, the runtime's own buffers, and fragmentation.  A constant (not
#: instantaneous ``bytes_in_use``) keeps every budget a pure function of the
#: chip, so launch shapes / compile-cache keys don't depend on which pipeline
#: stage probes first.
_RESERVE_BYTES = 2 << 30


def _probe() -> int | None:
    global _FREE_BYTES, _PROBED
    if _PROBED:
        return _FREE_BYTES
    _PROBED = True
    try:
        import jax

        dev = jax.devices()[0]
        stats = dev.memory_stats() or {}
        limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        if limit:
            _FREE_BYTES = max(int(limit) - _RESERVE_BYTES, 0)
    except Exception:
        _FREE_BYTES = None
    return _FREE_BYTES


def device_memory_budget(name: str, fraction: float, fallback: int) -> int:
    """``fraction`` of the device's free memory at first probe, else ``fallback``.

    Floors at 64 MiB so a nearly-full chip degrades to small windows rather
    than zero-size ones.  Each derived budget is recorded for
    :func:`budget_report` (profiling output).
    """
    free = _probe()
    if free is None:
        out = fallback
    else:
        out = max(int(free * fraction), 64 << 20)
    _GIVEN[name] = out
    return out


def budget_report() -> str:
    free = _probe()
    src = f"{free / 2**30:.2f} GiB free (memory_stats)" if free else "fallback constants"
    parts = ", ".join(f"{k}={v / 2**30:.2f} GiB" for k, v in sorted(_GIVEN.items()))
    return f"memory budgets [{src}]: {parts or 'none requested yet'}"
