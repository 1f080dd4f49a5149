"""Worker for tests/test_distributed.py — one process of a 2-host CPU run.

Streams its host shard of the FASTQ, scores it against the adaptor on the
global mesh, psums a global score histogram, and all-gathers the per-read
scores; writes everything to JSON for the parent to compare against the
single-process run.  Env: SARLACC_COORDINATOR / SARLACC_NUM_PROCS /
SARLACC_PROC_ID, WORKER_FASTQ, WORKER_OUT.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from sarlacc_tpu.api.align_internal import prepare_adaptor
    from sarlacc_tpu.io.fastq import stream_fastq
    from sarlacc_tpu.ops.align import dp_align, prepare_reads
    from sarlacc_tpu.parallel.distributed import (
        global_mesh,
        host_local_batch_to_global,
        host_shard,
        init_distributed,
    )

    rank, nprocs = init_distributed()
    assert nprocs == 2, f"expected 2 processes, got {nprocs}"
    mesh = global_mesh("reads")
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())

    # Host-sharded input: this process reads ONLY its byte range.
    chunks = list(
        stream_fastq(os.environ["WORKER_FASTQ"], shard=host_shard(), pad_to=80)
    )
    from sarlacc_tpu.core.encode import SeqBatch

    batch = SeqBatch.concat(chunks)
    names = list(batch.names or [])

    from sarlacc_tpu.parallel.distributed import common_local_rows

    ad = prepare_adaptor("ACGTACGTAANNNNNTTGCAGCATT")
    # Hosts agree on one local shard shape (sizes differ by a few reads
    # because shards split on byte boundaries).
    n = len(batch)
    rows = common_local_rows(n)
    pad = rows - n
    if pad:
        batch = SeqBatch.concat([batch, batch.take(np.zeros(pad, np.int64))])
    codes, qidx, lengths = prepare_reads(batch, ad.tables)
    lengths = jnp.where(jnp.arange(lengths.shape[0]) < n, lengths, 0)

    gcodes, gqidx, glens = host_local_batch_to_global(
        mesh, codes, qidx, lengths, axis="reads"
    )

    def local_scores(codes, qidx, lens):
        s, _ = dp_align(
            codes, qidx, lens, ad.modes, ad.matched, ad.match_tab,
            ad.mismatch_tab, 5.0, 1.0, local=True, need_directions=False,
        )
        return s

    @jax.jit
    def step(codes, qidx, lens):
        def shard_fn(codes, qidx, lens):
            s = local_scores(codes, qidx, lens)
            live = (lens > 0).astype(jnp.float32)
            # Global score histogram by collective (no gathering of reads).
            edges = jnp.linspace(-50.0, 50.0, 21)
            idx = jnp.clip(jnp.searchsorted(edges, s), 0, 21 - 1)
            hist = jnp.zeros(21, jnp.float32).at[idx].add(live)
            hist = jax.lax.psum(hist, "reads")
            gathered = jax.lax.all_gather(s, "reads", tiled=True)
            return hist, gathered

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("reads"), P("reads"), P("reads")),
            out_specs=(P(), P()),
            check_vma=False,  # scan carries start replicated (as mesh.py)
        )(codes, qidx, lens)

    hist, gathered = step(gcodes, gqidx, glens)
    out = {
        "rank": rank,
        "n_global_devices": n_dev,
        "n_local_reads": n,
        "n_local_padded": int(len(batch)),
        "names": names,
        # `gathered` is fully replicated: every host sees all padded scores.
        "hist": np.asarray(jax.device_get(hist)).tolist(),
        "scores_global": [
            round(float(x), 5)
            for x in np.asarray(jax.device_get(gathered)).tolist()
        ],
    }
    with open(os.environ["WORKER_OUT"], "w") as fh:
        json.dump(out, fh)
    print(f"worker {rank} done", flush=True)


if __name__ == "__main__":
    main()
