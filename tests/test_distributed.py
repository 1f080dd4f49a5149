"""Multi-host last mile (SURVEY.md §5.8, §7.2(5),(7)).

* ``fastq_shard_range`` byte ranges tile the file exactly, including the
  '@'-leading-quality ambiguity, so rank-ordered shard streams reproduce
  the single-host stream record-for-record;
* a REAL two-process ``jax.distributed`` CPU run (gloo collectives) streams
  host-sharded input, scores it on the 4-device global mesh, and its psum
  histogram + all-gathered scores match the single-process computation
  byte-for-byte — the BiocParallel-multi-machine analog
  (/root/reference/R/adaptorAlign.R:127-129).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from sarlacc_tpu.io.fastq import (
    fastq_shard_range,
    read_fastq,
    stream_fastq,
    write_fastq,
)

HERE = pathlib.Path(__file__).parent


def _tricky_fastq(path, n=257, seed=11):
    """Records whose quality lines often start with '@' or '+' (the
    classic record-boundary ambiguity) and whose lengths vary."""
    rng = np.random.default_rng(seed)
    seqs, quals, names = [], [], []
    for i in range(n):
        ln = int(rng.integers(1, 70))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        lead = "@" if i % 3 == 0 else ("+" if i % 3 == 1 else "J")
        quals.append(lead + "".join(chr(int(c)) for c in rng.integers(64, 90, ln - 1)) if ln > 1 else lead)
        names.append(f"r{i}")
    write_fastq(path, seqs=seqs, quals=quals, names=names)
    return names


def test_shard_ranges_tile_file():
    fp = tempfile.mktemp(suffix=".fastq")
    names = _tricky_fastq(fp)
    whole = read_fastq(fp)
    size = os.path.getsize(fp)
    try:
        for nshards in (1, 2, 3, 7):
            ranges = [fastq_shard_range(fp, r, nshards) for r in range(nshards)]
            # Contiguous tiling: starts/ends chain and cover [0, size).
            assert ranges[0][0] == 0 and ranges[-1][1] == size
            for (s0, e0), (s1, e1) in zip(ranges, ranges[1:]):
                assert e0 == s1
            got_names: list[str] = []
            for r in range(nshards):
                for chunk in stream_fastq(fp, chunk_size=50, shard=(r, nshards)):
                    got_names.extend(chunk.names or [])
            assert got_names == names, f"nshards={nshards}"
    finally:
        os.remove(fp)


def test_two_process_distributed_parity():
    fp = tempfile.mktemp(suffix=".fastq")
    _tricky_fastq(fp, n=203, seed=23)
    outs = [tempfile.mktemp(suffix=".json") for _ in range(2)]
    port = 29531
    procs = []
    try:
        for rank in range(2):
            env = {
                k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
            }
            env.update(
                JAX_PLATFORMS="cpu",
                JAX_CPU_COLLECTIVES_IMPLEMENTATION="gloo",
                XLA_FLAGS="--xla_force_host_platform_device_count=2",
                SARLACC_COORDINATOR=f"localhost:{port}",
                SARLACC_NUM_PROCS="2",
                SARLACC_PROC_ID=str(rank),
                WORKER_FASTQ=fp,
                WORKER_OUT=outs[rank],
            )
            procs.append(
                subprocess.Popen(
                    [sys.executable, str(HERE / "distributed_worker.py")],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                )
            )
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append(out.decode(errors="replace"))
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

        res = [json.load(open(o)) for o in outs]
    finally:
        os.remove(fp)
        for o in outs:
            if os.path.exists(o):
                os.remove(o)
        for p in procs:
            if p.poll() is None:
                p.kill()

    assert res[0]["n_global_devices"] == 4
    # Host shards partition the reads (contiguous, in rank order).
    whole_names = [f"r{i}" for i in range(203)]
    assert res[0]["names"] + res[1]["names"] == whole_names

    # Single-process reference computation (identical code path).
    from sarlacc_tpu.api.align_internal import prepare_adaptor
    from sarlacc_tpu.core.encode import SeqBatch
    from sarlacc_tpu.ops.align import dp_align, prepare_reads

    fp2 = tempfile.mktemp(suffix=".fastq")
    _tricky_fastq(fp2, n=203, seed=23)
    ad = prepare_adaptor("ACGTACGTAANNNNNTTGCAGCATT")
    try:
        whole = read_fastq(fp2, pad_to=80)
    finally:
        os.remove(fp2)
    codes, qidx, lengths = prepare_reads(whole, ad.tables)
    want, _ = dp_align(
        codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab,
        ad.mismatch_tab, 5.0, 1.0, local=True, need_directions=False,
    )
    want = np.asarray(want).astype(np.float32)

    # The all-gathered scores interleave each host's padding rows at the
    # end of its block; strip them using the reported local sizes.
    got = []
    at = 0
    for r in res:
        got.extend(r["scores_global"][at : at + r["n_local_reads"]])
        at += r["n_local_padded"]
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-4)

    # Both hosts saw the same global psum histogram, matching the
    # single-process histogram of real (non-padding) reads.
    assert res[0]["hist"] == res[1]["hist"]
    edges = np.linspace(-50.0, 50.0, 21, dtype=np.float32)
    idx = np.clip(np.searchsorted(edges, want), 0, 20)
    ref_hist = np.zeros(21, np.float32)
    np.add.at(ref_hist, idx, 1.0)
    np.testing.assert_allclose(np.asarray(res[0]["hist"]), ref_hist)
