"""Profile multi_read_align at ~10k groups: total time, the profiler's
stage split, and the share of host-side orchestration in the MSA stage.

Usage: python scripts/profile_msa_scale.py [n_groups] [reads_per_group] [len]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sarlacc_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402


def main():
    args = sys.argv[1:]
    n_groups = int(args[0]) if args else 10_000
    per = int(args[1]) if len(args) > 1 else 10
    L = int(args[2]) if len(args) > 2 else 500

    import sarlacc_tpu as st
    from sarlacc_tpu.core.encode import SeqBatch
    from sarlacc_tpu.utils.profiling import (
        PipelineProfiler,
        get_profiler,
        set_profiler,
    )

    rng = np.random.default_rng(11)
    n = n_groups * per
    # Noisy copies of one template per group (realistic MSA input).
    templates = rng.integers(0, 4, (n_groups, L)).astype(np.int8)
    codes = np.repeat(templates, per, axis=0)
    sub = rng.random((n, L)) < 0.08
    codes[sub] = rng.integers(0, 4, int(sub.sum()))
    lengths = np.full(n, L, np.int64)
    batch = SeqBatch(codes, lengths, None, None)
    groups = np.repeat(np.arange(n_groups), per)
    print(f"[cfg] {n_groups} groups x {per} reads x {L} bp", file=sys.stderr)

    # Initialise the device and the device->host path before timing.
    import jax.numpy as jnp

    np.asarray(jnp.zeros(8, jnp.int32) + 1)

    set_profiler(PipelineProfiler())
    t0 = time.time()
    out = st.multi_read_align(batch, groups=groups, bandwidth=100)
    elapsed = time.time() - t0
    assert len(out) == n_groups
    prof = get_profiler()
    host_stages = (
        "msa.merge_cost", "msa.apply_merge", "msa.guide_tree",
        "msa.reconstruct", "msa.pair_postprocess",
    )
    host = sum(prof.stages[s].seconds for s in host_stages if s in prof.stages)
    print(prof.report(), file=sys.stderr)
    print(json.dumps({
        "n_groups": n_groups,
        "n_reads": n,
        "seconds": round(elapsed, 2),
        "reads_per_s": round(n / elapsed, 1),
        "host_orchestration_s": round(host, 2),
        "host_share": round(host / elapsed, 4),
    }))


if __name__ == "__main__":
    main()
