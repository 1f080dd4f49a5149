"""Time what XLA makes of the alignment DP kernels on the GPU, at real widths.

Usage: python scripts/xla_kernel_times.py

* ``dp_align(need_directions=False)`` at the demux shape (100k reads x 250
  bp; adaptor 1 and adaptor 2 of the bench against read fronts and backs,
  the four launches of strand resolution);
* ``dp_align(need_directions=True)`` at the pipeline's adaptor shape (both
  orientations of the ~10k-read bench workload stacked);
* ``_banded_pair_kernel`` and its device walk per launch at the largest
  (rows, W) bucket the ~10k-read pipeline emits, with its pair chunk;
* the share of the ``msa.pair_library`` span in ``multi_read_align`` over
  one warm pipeline pass.

Each kernel is compiled once and its ``memory_analysis()`` printed before
timing; times are medians of ``block_until_ready`` launches.  Every line
names the card and its power limit.  Refuses to run off a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(fn, reps=10):
    import jax

    jax.block_until_ready(fn())  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(min(ts)), float(max(ts))


def _bkt(x, base=64):
    b = base
    while b < x:
        b *= 2
    return b


def main(n_demux: int = 100_000, n_molecules: int = 950) -> int:
    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke
    import sarlacc_tpu as st
    from sarlacc_tpu.api.align_internal import prepare_adaptor
    from sarlacc_tpu.ops.align import dp_align, prepare_reads
    from sarlacc_tpu.ops.msa import _banded_pair_kernel, _pair_chunk, _pair_walk_kernel
    from sarlacc_tpu.utils.cache import enable_persistent_cache
    from sarlacc_tpu.utils.device import device_record
    from sarlacc_tpu.utils.profiling import PipelineProfiler, get_profiler, set_profiler

    try:
        dev = device_record()
    except RuntimeError as e:
        print(f"xla_kernel_times: {e}", file=sys.stderr)
        return 2
    enable_persistent_cache()
    card = dev["cards"][0]
    results = {"device": dev}

    def report(name, fn, args, static, cells):
        compiled = fn.lower(*args, **static).compile()
        print(f"[memory] {name}: {chip_smoke._memory_line(compiled)}", flush=True)
        med, lo, hi = _time(lambda: fn(*args, **static))
        out = {"ms": med * 1e3, "ms_min": lo * 1e3, "ms_max": hi * 1e3,
               "cells": int(cells), "gcups": cells / med / 1e9}
        print(f"[time] {name}: {out['ms']:.3f} ms (min {out['ms_min']:.3f}, max "
              f"{out['ms_max']:.3f}), {out['gcups']:.2f} GCUPS on {card}", flush=True)
        results[name] = out

    # dp_align scores at the demux shape: the four strand-resolution launches.
    a1 = prepare_adaptor(bench.ADAPTOR1)
    a2 = prepare_adaptor(bench.ADAPTOR2)
    n, tol = n_demux, 250
    front = prepare_reads(bench._random_reads(n, tol, 3), a1.tables)
    back = prepare_reads(bench._random_reads(n, tol, 4), a1.tables)
    for tag, ad, reads in (("a1@front", a1, front), ("a2@back", a2, back),
                           ("a1@back", a1, back), ("a2@front", a2, front)):
        report(f"dp_align scores {tag} [{n}, {tol}] x R={len(ad)}", dp_align,
               (*reads, ad.modes, ad.matched, ad.match_tab, ad.mismatch_tab, 5.0, 1.0),
               dict(local=True, need_directions=False), n * tol * len(ad))

    # dp_align directions at the pipeline's adaptor shape.
    adaptor1, adaptor2, batch = bench.build_workload(n_molecules=n_molecules)
    front, back = batch.front_and_back(250)
    for ad_seq, stacked in ((adaptor1, [front, back]), (adaptor2, [back, front])):
        ad = prepare_adaptor(ad_seq)
        reads = prepare_reads(type(batch).concat(stacked), ad.tables)
        N, L = reads[0].shape
        report(f"dp_align directions [{N}, {L}] x R={len(ad)}", dp_align,
               (*reads, ad.modes, ad.matched, ad.match_tab, ad.mismatch_tab, 5.0, 1.0),
               dict(local=True, need_directions=True), N * L * len(ad))

    # One pipeline pass to compile, one warm pass under a fresh profiler.
    bench.run_pipeline(adaptor1, adaptor2, batch)
    set_profiler(PipelineProfiler())
    bench.run_pipeline(adaptor1, adaptor2, batch)
    stages = get_profiler().stages
    mra = stages["multi_read_align"].seconds
    pl = stages["msa.pair_library"]
    results["pipeline_msa"] = {
        "multi_read_align_s": mra,
        "msa.pair_library_s": pl.seconds,
        "pair_library_share": pl.seconds / mra,
        "pair_library_pairs": pl.items,
        "pair_library_cells": pl.cells,
    }
    print(f"[span] multi_read_align {mra:.3f} s, msa.pair_library {pl.seconds:.3f} s "
          f"(share {pl.seconds / mra:.4f}; {pl.items} pairs) on {card}", flush=True)
    print(get_profiler().report(), flush=True)

    # The largest (rows, W) pair bucket of that pipeline: the same groups
    # and realized reads multi_read_align saw.
    aligned = st.adaptor_align(adaptor1, adaptor2, reads=batch, tolerance=250)
    groups = st.umi_group(aligned["adaptor1"]["subseq"]["Sub2"], threshold1=2)
    reads = st.realize_reads(aligned, reads=batch, trim=False)
    lens = reads.lengths.astype(np.int64)
    ga, gb = [], []
    for g in groups:
        if len(g) >= 2:
            x, y = np.triu_indices(len(g), k=1)
            ga.append(np.asarray(g)[x])
            gb.append(np.asarray(g)[y])
    ga, gb = np.concatenate(ga), np.concatenate(gb)
    bw = 100
    la, lb = lens[ga], lens[gb]
    lo = np.minimum(0, lb - la) - bw
    hi = np.maximum(0, lb - la) + bw
    rows_c = np.asarray([_bkt(max(int(v), 1)) for v in la])
    w_c = np.asarray([_bkt(int(v)) for v in hi - lo + 1])
    keys, counts = np.unique(np.stack([rows_c, w_c], 1), axis=0, return_counts=True)
    print("[buckets] (rows, W): pairs — " + ", ".join(
        f"({r}, {w}): {c}" for (r, w), c in zip(keys.tolist(), counts.tolist())), flush=True)
    rows, W = keys[np.lexsort((counts, keys[:, 0] * keys[:, 1]))[-1]].tolist()
    sel = np.flatnonzero((rows_c == rows) & (w_c == W))
    P = _pair_chunk(rows, W)
    pick = sel[np.arange(P) % sel.size]
    lb_w = _bkt(int(lb[pick].max()))
    codes = reads.codes

    def pad(rows_idx, width):
        out = np.full((P, width), 5, np.int32)
        c = codes[rows_idx][:, :width]
        out[:, : c.shape[1]] = c
        return out

    args = (jnp.asarray(pad(ga[pick], rows)), jnp.asarray(pad(gb[pick], lb_w)),
            jnp.asarray(la[pick], jnp.int32), jnp.asarray(lb[pick], jnp.int32),
            jnp.asarray(lo[pick], jnp.int32), jnp.asarray(hi[pick] - lo[pick], jnp.int32))
    results["pair_bucket"] = {"rows": rows, "W": W, "pairs_in_bucket": int(sel.size),
                              "pair_chunk": P}
    report(f"_banded_pair_kernel ({rows}, {W}) x P={P}", _banded_pair_kernel,
           (*args, 0.0, -1.0, 5.0, 1.0), dict(rows=rows, width=W), P * rows * W)
    _, dirs = _banded_pair_kernel(*args, 0.0, -1.0, 5.0, 1.0, rows=rows, width=W)
    report(f"_pair_walk_kernel ({rows}, {W}) x P={P}", _pair_walk_kernel,
           (dirs, args[2], args[3], args[4]), {}, P * rows * W)

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
