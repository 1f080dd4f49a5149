"""Probe MSA wall-clock scaling AND host RSS growth at bench-shaped scale.

A vignette-scale (~500k-read) run can grow host RSS and MSA wall time
superlinearly; this probe measures both at a diagnosable size:
bench-shaped groups (variable lengths 400-700, variable sizes 8-14) across
n_groups, logging RSS and the profiler stage split per slice.

Usage: python scripts/probe_msa_scale_mem.py [n_groups] [slices]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sarlacc_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024 / 1024
    return 0.0


def build(n_groups, seed=5):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(8, 15, n_groups)
    n = int(sizes.sum())
    lens = rng.integers(400, 701, n)
    L = int(lens.max())
    codes = np.full((n, L), 5, np.int8)
    groups = np.repeat(np.arange(n_groups), sizes)
    # noisy copies of a per-group template, trimmed/padded to each length
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for g in range(n_groups):
        t = rng.integers(0, 4, 700).astype(np.int8)
        for m in range(sizes[g]):
            i = starts[g] + m
            li = lens[i]
            row = t[:li].copy()
            mut = rng.random(li) < 0.08
            row[mut] = rng.integers(0, 4, int(mut.sum()))
            codes[i, :li] = row
    from sarlacc_tpu.core.encode import SeqBatch

    return SeqBatch(codes, lens.astype(np.int64), None, None), groups


def main():
    n_groups = int(sys.argv[1]) if len(sys.argv) > 1 else 8000
    slices = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    import jax.numpy as jnp

    import sarlacc_tpu as st
    from sarlacc_tpu.utils.profiling import PipelineProfiler, set_profiler

    np.asarray(jnp.zeros(8, jnp.int32) + 1)  # warm claim + D2H channel

    per = n_groups // slices
    print(f"[cfg] {n_groups} bench-shaped groups in {slices} slices of {per}",
          flush=True)
    for s in range(slices):
        batch, groups = build(per, seed=100 + s)
        r0, t0 = rss_gb(), time.time()
        prof = PipelineProfiler()
        set_profiler(prof)
        out = st.multi_read_align(batch, groups=groups, bandwidth=100)
        dt = time.time() - t0
        assert len(out) == per
        del out
        print(
            f"[slice {s}] {per} groups ({len(batch)} reads): {dt:.1f} s "
            f"({len(batch)/dt:.0f} reads/s)  RSS {r0:.1f} -> {rss_gb():.1f} GB",
            flush=True,
        )
        print(prof.report(), flush=True)


if __name__ == "__main__":
    main()
