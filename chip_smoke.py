"""Smoke test of the correction pipeline on one NVIDIA GPU.

Usage:
    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --cards 4   # only the multi-device mesh path

Phases, in order, in one process:

1. device    — refuse anything but a GPU; print the card, JAX, the compile
               cache, the memory budgets and the native host library.
2. compile   — lower and compile the jitted stages at the main path's
               shapes; print each one's ``memory_analysis()``.
3. reference — compare on the card with the plain references: ``dp_align``
               scores and device-walk query maps against ``refimpl/align.py``,
               ``barcode_align`` against the per-barcode reference loop, the
               banded pair kernel against a full-matrix Gotoh oracle, and
               the golden mock pipeline snapshot.
4. main      — the bench's ~10k-read pipeline end to end, 100k-read demux
               (4 score-only launches + 12 barcodes) and 100k-UMI grouping,
               through the public API.

Any failed phase exits non-zero.  The last line of standard output is one
JSON object naming the device; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

#: float32 device sums of log-quality costs against float64 reference sums,
#: over up to ~300 cells of one alignment path.
SCORE_ATOL = 1e-3


class PhaseError(AssertionError):
    """A comparison on the card disagreed with its reference."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- phase 1


def phase_device():
    """Returns (device, nvidia-smi card lines); RuntimeError off a GPU."""
    import jax

    from sarlacc_tpu.native import native_available
    from sarlacc_tpu.utils.cache import enable_persistent_cache
    from sarlacc_tpu.utils.device import card_lines, require_gpu
    from sarlacc_tpu.utils.membudget import budget_report

    dev = require_gpu()
    cards = card_lines()
    for line in cards:
        print(line)
    log(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    log(f"[device] compile cache: {enable_persistent_cache()}")
    log(f"[device] {budget_report()}")
    native = native_available()
    log(f"[device] native host library built: {native}")
    check(native, "the native host library did not build")
    return dev, cards


# --------------------------------------------------------------- phase 2


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    mib = 1 << 20
    return (
        f"args {m.argument_size_in_bytes / mib:.1f} MiB, "
        f"out {m.output_size_in_bytes / mib:.1f} MiB, "
        f"temp {m.temp_size_in_bytes / mib:.1f} MiB, "
        f"code {m.generated_code_size_in_bytes / mib:.2f} MiB"
    )


def stage_specs(n_demux: int, tol: int, n_pipe: int, pair_rows: int, pair_w: int):
    """(name, jitted fn, args, static kwargs) of the main path's jitted
    stages at their real shapes."""
    import jax
    import jax.numpy as jnp

    from sarlacc_tpu.api.align_internal import prepare_adaptor
    from sarlacc_tpu.ops.align import dp_align
    from sarlacc_tpu.ops.backtrack import qmap_walk_device
    from sarlacc_tpu.ops.msa import _banded_pair_kernel, _pair_chunk, _pair_walk_kernel

    import bench

    sds = jax.ShapeDtypeStruct

    def reads(n, width):
        return (sds((n, width), jnp.int8), sds((n, width), jnp.int8),
                sds((n,), jnp.int32))

    def ref(adaptor):
        a = prepare_adaptor(adaptor)
        return (a.modes, a.matched, a.match_tab, a.mismatch_tab), len(a)

    r1, len1 = ref(bench.ADAPTOR1)
    r2, _ = ref(bench.ADAPTOR2)
    rbc, lbc = ref("ACGTACGTACGT")
    P = _pair_chunk(pair_rows, pair_w)
    pairs = (sds((P, pair_rows), jnp.int32), sds((P, pair_rows + pair_w), jnp.int32),
             sds((P,), jnp.int32), sds((P,), jnp.int32), sds((P,), jnp.int32),
             sds((P,), jnp.int32))
    return [
        (f"dp_align scores [{n_demux}, {tol}] x R={len1}", dp_align,
         (*reads(n_demux, tol), *r1, 5.0, 1.0),
         dict(local=True, need_directions=False)),
        (f"dp_align scores [{n_demux}, {tol}] x R=14", dp_align,
         (*reads(n_demux, tol), *r2, 5.0, 1.0),
         dict(local=True, need_directions=False)),
        (f"dp_align global scores [{n_demux}, 12] x R={lbc}", dp_align,
         (*reads(n_demux, 12), *rbc, 5.0, 1.0),
         dict(local=False, need_directions=False)),
        (f"dp_align directions [{n_pipe}, {tol}] x R={len1}", dp_align,
         (*reads(n_pipe, tol), *r1, 5.0, 1.0),
         dict(local=True, need_directions=True)),
        (f"qmap_walk_device [{len1}, {n_pipe}, {tol + 1}]", qmap_walk_device,
         (sds((len1, n_pipe, tol + 1), jnp.int16), sds((n_pipe,), jnp.int32)), {}),
        (f"_banded_pair_kernel ({pair_rows}, {pair_w}) x P={P}", _banded_pair_kernel,
         (*pairs, 0.0, -1.0, 5.0, 1.0), dict(rows=pair_rows, width=pair_w)),
        (f"_pair_walk_kernel ({pair_rows}, {pair_w}) x P={P}", _pair_walk_kernel,
         (sds((pair_rows, P, pair_w), jnp.int8), *pairs[2:5]), {}),
    ]


def phase_compile(specs):
    for name, fn, args, static in specs:
        t0 = time.time()
        compiled = fn.lower(*args, **static).compile()
        log(f"[compile] {name}: {time.time() - t0:.1f} s; {_memory_line(compiled)}")


# --------------------------------------------------------------- phase 3


def _reads(rng, n, length, alphabet="ACGT"):
    seqs = ["".join(rng.choice(list(alphabet), length)) for _ in range(n)]
    quals = ["".join(chr(int(c)) for c in rng.integers(35, 75, length)) for _ in range(n)]
    return seqs, quals


def _planted(rng, n, length, adaptor, err=0.05):
    """Read fronts holding a noisy copy of the adaptor after a short random
    prefix, as real reads do; their alignments are rarely ambiguous."""
    seqs, quals = _reads(rng, n, length)
    out = []
    for s in seqs:
        a = [str(rng.choice(list("ACGT"))) if c == "N" else c for c in adaptor]
        noisy = []
        for c in a:
            r = rng.random()
            if r < err / 3:
                continue  # deletion
            noisy.append(str(rng.choice(list("ACGT"))) if r < 2 * err / 3 else c)
            if r > 1 - err / 3:
                noisy.append(str(rng.choice(list("ACGT"))))  # insertion
        at = int(rng.integers(0, 20))
        out.append((s[:at] + "".join(noisy) + s[at:])[:length])
    return out, quals


def check_dp_align(n_reads=512, tol=250, n_maps=128, seed=11):
    """Device scores (half planted-adaptor reads, half random reads with N
    bases) and query maps (planted reads) at the demux read width against
    the float64 reference aligner."""
    from sarlacc_tpu.api.align_internal import align_scores_only, prepare_adaptor
    from sarlacc_tpu.core.encode import SeqBatch
    from sarlacc_tpu.ops.align import dp_align, prepare_reads
    from sarlacc_tpu.ops.backtrack import qmap_walk_device
    from sarlacc_tpu.refimpl.align import ReferenceAlign

    import bench

    rng = np.random.default_rng(seed)
    planted = _planted(rng, n_reads // 2, tol, bench.ADAPTOR1)
    rand = _reads(rng, n_reads - n_reads // 2, tol, "ACGTN")
    seqs, quals = planted[0] + rand[0], planted[1] + rand[1]
    batch = SeqBatch.from_strings(seqs, quals)
    a1 = prepare_adaptor(bench.ADAPTOR1)
    got = align_scores_only(a1, batch, 5.0, 1.0)
    codes, qidx, lengths = prepare_reads(batch.take(np.arange(n_maps)), a1.tables)
    _, dirs = dp_align(codes, qidx, lengths, a1.modes, a1.matched, a1.match_tab,
                       a1.mismatch_tab, 5.0, 1.0, local=True, need_directions=True)
    is_match, dp_row = (np.asarray(x) for x in qmap_walk_device(dirs, lengths))

    ra = ReferenceAlign(bench.ADAPTOR1, 5, 1)
    want = np.zeros(n_reads)
    agree = 0
    for i, (s, q) in enumerate(zip(seqs, quals)):
        want[i] = ra.align(s, q, local=True)
        if i < n_maps:
            ref_map = [(bool(m), int(r)) for m, r in ra.fill_map().mapping]
            agree += ref_map == list(zip(is_match[i].tolist(), dp_row[i].tolist()))
    err = float(np.abs(got - want).max())
    log(f"[reference] dp_align scores, {n_reads} reads x {tol} bp x R={len(a1)}: "
        f"max |float32 card - float64 reference| = {err:.2e} (atol {SCORE_ATOL})")
    check(err <= SCORE_ATOL, f"dp_align scores differ by {err}")
    log(f"[reference] device-walk query maps equal the reference walk for "
        f"{agree}/{n_maps} planted-adaptor reads (float32 tie-breaks between "
        f"co-optimal paths tolerated: >= 90%)")
    check(agree >= 0.9 * n_maps, f"only {agree}/{n_maps} query maps agree")


def check_barcodes(n_reads=512, n_barcodes=12, bc_len=12, seed=12):
    """barcode_align's device best/second-best against the reference's
    sequential per-barcode loop (R/barcodeAlign.R:27-38)."""
    import sarlacc_tpu as st
    from sarlacc_tpu.core.encode import SeqBatch
    from sarlacc_tpu.refimpl.align import ReferenceAlign

    rng = np.random.default_rng(seed)
    barcodes = ["".join(rng.choice(list("ACGT"), bc_len)) for _ in range(n_barcodes)]
    seqs, quals = _reads(rng, n_reads, bc_len)
    got = st.barcode_align(SeqBatch.from_strings(seqs, quals), barcodes)
    per = np.stack([
        [ReferenceAlign(bc, 5, 1).align(s, q, local=False) for s, q in zip(seqs, quals)]
        for bc in barcodes
    ])
    best = per.max(axis=0)
    second = np.sort(per, axis=0)[-2]
    ids = np.asarray(got["barcode"])
    err = max(float(np.abs(got["score"] - best).max()),
              float(np.abs(got["score"] - got["gap"] - second).max()))
    same = int((ids == np.argmax(per, axis=0)).sum())
    # Where two barcodes score within float32 noise of each other, either
    # is a correct call: the chosen one must hold the best score.
    best_held = int((per[ids, np.arange(n_reads)] >= best - SCORE_ATOL).sum())
    log(f"[reference] barcode_align, {n_reads} reads x {n_barcodes} barcodes: "
        f"max score error {err:.2e}; assignments equal {same}/{n_reads}, "
        f"hold the best score {best_held}/{n_reads}")
    check(err <= SCORE_ATOL, f"barcode scores differ by {err}")
    check(best_held == n_reads, f"{n_reads - best_held} barcode calls miss the best score")


def gotoh_banded_scores(ca, la, cb, lb, lo, hi, match, mismatch, go, ge):
    """Full-matrix Gotoh global scores with SeqAn's gap convention (a gap of
    length k costs go + (k-1)*ge), cells off the band lo <= j - i <= hi
    unreachable.  Loops over cells, vectorised over pairs only."""
    P = ca.shape[0]
    LA, LB = int(la.max()), int(lb.max())
    neg = -np.inf
    jj = np.arange(LB + 1)
    out = np.full(P, np.nan)

    def band(i):
        d = jj[None, :] - i
        return (d >= lo[:, None]) & (d <= hi[:, None]) & (jj[None, :] <= lb[:, None])

    S = np.full((P, LB + 1), neg)
    H = np.full((P, LB + 1), neg)
    V = np.full((P, LB + 1), neg)
    S[:, 0] = 0.0
    for j in range(1, LB + 1):
        H[:, j] = np.maximum(S[:, j - 1] - go, H[:, j - 1] - ge)
        S[:, j] = H[:, j]
    m0 = band(0)
    S[~m0] = neg
    H[~m0] = neg
    out[la == 0] = S[la == 0, lb[la == 0]]
    for i in range(1, LA + 1):
        mask = band(i)
        M = np.full((P, LB + 1), neg)
        M[:, 1:] = S[:, :-1] + np.where(ca[:, i - 1][:, None] == cb[:, :LB], match, mismatch)
        Vn = np.maximum(S - go, V - ge)
        M[~mask] = neg
        Vn[~mask] = neg
        Sn = np.maximum(M, Vn)
        Hn = np.full((P, LB + 1), neg)
        for j in range(1, LB + 1):
            h = np.where(mask[:, j], np.maximum(Sn[:, j - 1] - go, Hn[:, j - 1] - ge), neg)
            Hn[:, j] = h
            Sn[:, j] = np.maximum(Sn[:, j], h)
        S, H, V = Sn, Hn, Vn
        done = la == i
        out[done] = S[done, lb[done]]
    return out


def check_banded_pairs(n_pairs=64, bandwidth=6, seed=13):
    """The banded pair kernel (through ``banded_pair_align``: bucketing,
    padding, kernel, walk) at the (512, 1024) bucket against the Gotoh
    oracle; scores are integers, so equality is exact."""
    from sarlacc_tpu.core.encode import encode_batch
    from sarlacc_tpu.ops.msa import banded_pair_align

    rng = np.random.default_rng(seed)
    seq_a, seq_b = [], []
    for _ in range(n_pairs):
        a = "".join(rng.choice(list("ACGT"), int(rng.integers(257, 300))))
        ins = "".join(rng.choice(list("ACGT"), int(rng.integers(500, 520))))
        at = int(rng.integers(0, len(a) + 1))
        b = list(a[:at] + ins + a[at:])
        for _ in range(len(a) // 20):
            b[int(rng.integers(0, len(b)))] = str(rng.choice(list("ACGT")))
        seq_a.append(a)
        seq_b.append("".join(b))
    ca, la = encode_batch(seq_a)
    cb, lb = encode_batch(seq_b)
    la, lb = la.astype(np.int32), lb.astype(np.int32)
    d = lb.astype(np.int64) - la
    lo, hi = np.minimum(0, d) - bandwidth, np.maximum(0, d) + bandwidth
    check(la.max() <= 512 < (hi - lo + 1).min() and (hi - lo + 1).max() <= 1024
          and la.min() > 256, "pairs fall outside the (512, 1024) bucket")
    got, _ = banded_pair_align(ca.astype(np.int32), la, cb.astype(np.int32), lb,
                               0.0, -1.0, 5.0, 1.0, bandwidth)
    want = gotoh_banded_scores(ca, la, cb, lb, lo, hi, 0.0, -1.0, 5.0, 1.0)
    same = int((got == want).sum())
    log(f"[reference] banded pair kernel, {n_pairs} pairs at bucket (512, 1024): "
        f"scores equal the Gotoh oracle for {same}/{n_pairs}")
    check(same == n_pairs, f"{n_pairs - same} banded pair scores differ")


def check_golden_pipeline():
    """The seeded mock pipeline against its checked-in snapshot: every
    integer, strand, group, MSA string and consensus string and quality
    exactly; scores to SCORE_ATOL."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_pipeline", ROOT / "tests" / "test_golden_pipeline.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    snap = mod._run_pipeline()
    want = json.loads(mod.GOLDEN.read_text())
    bad = []
    for key in sorted(want):
        if key.endswith("_score"):
            err = float(np.abs(np.asarray(snap[key]) - np.asarray(want[key])).max())
            if err > SCORE_ATOL:
                bad.append(f"{key} (max error {err:.2e})")
        elif snap[key] != want[key]:
            bad.append(key)
    log(f"[reference] golden mock pipeline ({want['n_reads']} reads, "
        f"{len(want['alignments'])} MSAs): mismatched fields: {bad or 'none'}")
    check(not bad, f"golden pipeline mismatch in {bad}")


# --------------------------------------------------------------- phase 4


def phase_main(card: str, workload, n_demux=100_000, n_umi=100_000):
    """The public-API main path at real size; checks shapes and values."""
    import sarlacc_tpu as st

    import bench

    adaptor1, adaptor2, batch = workload
    stages: list = []
    t0 = time.time()
    nreads, ncons = bench.run_pipeline(adaptor1, adaptor2, batch, timings=stages)
    wall = time.time() - t0
    check(nreads == len(batch) and ncons > 0, "pipeline produced no consensus")
    split = ", ".join(
        f"{name} {t - prev:.2f} s"
        for (name, t), (_, prev) in zip(stages[1:], stages[:-1])
    )
    log(f"[main] pipeline {nreads} reads -> {ncons} consensus reads in {wall:.2f} s "
        f"(first pass, compilation included; {split}) on {card}")

    inp = bench.demux_inputs(n_reads=n_demux)
    t0 = time.time()
    scores, is_rev, bc = bench.demux_pass(inp)
    wall = time.time() - t0
    n = len(inp["front"])
    check(scores.shape == (4, n) and np.isfinite(scores).all(), "demux scores malformed")
    ids = np.asarray(bc["barcode"])
    check(ids.shape == (n,) and ids.min() >= 0 and ids.max() < len(inp["barcodes"])
          and np.isfinite(np.asarray(bc["score"])).all(), "barcode calls malformed")
    log(f"[main] demux {n} reads x 4 score-only launches + {len(inp['barcodes'])} "
        f"barcodes in {wall:.2f} s (compilation included; {int(is_rev.sum())} "
        f"reversed) on {card}")

    umis = bench.umi_inputs(n_umis=n_umi, n_clusters=n_umi // 5)
    t0 = time.time()
    groups = st.umi_group(umis, threshold1=2)
    wall = time.time() - t0
    flat = np.sort(np.concatenate(groups))
    check(np.array_equal(flat, np.arange(len(umis))), "UMI groups do not partition the reads")
    log(f"[main] umi_group {len(umis)} UMIs -> {len(groups)} groups in {wall:.2f} s "
        f"(compilation included) on {card}")


# ------------------------------------------------------------ --cards 4


def mesh_checks(mesh, solo, n_dp=100_000, n_step=8192, n_umi=100_000,
                n_molecules=60, log_prefix="[mesh]"):
    """The reads-axis mesh path against the same calls on one device, in
    this process: every result must be equal."""
    import jax

    import sarlacc_tpu as st
    from sarlacc_tpu.api.align_internal import prepare_adaptor
    from sarlacc_tpu.core.encode import SeqBatch
    from sarlacc_tpu.ops.align import prepare_reads
    from sarlacc_tpu.parallel.mesh import (
        shard_reads, sharded_adaptor_scores, sharded_pipeline_step,
    )
    from sarlacc_tpu.parallel.shuffle import sharded_pregroup_msa

    import bench

    a1 = prepare_adaptor(bench.ADAPTOR1)
    a2 = prepare_adaptor(bench.ADAPTOR2)
    p1 = (a1.modes, a1.matched, a1.match_tab, a1.mismatch_tab)
    p2 = (a2.modes, a2.matched, a2.match_tab, a2.mismatch_tab)

    def equal(name, a, b):
        a = jax.tree_util.tree_map(np.asarray, a)
        b = jax.tree_util.tree_map(np.asarray, b)
        same = all(np.array_equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                                        jax.tree_util.tree_leaves(b)))
        log(f"{log_prefix} {name}: {'equal' if same else 'DIFFERENT'}")
        check(same, f"{name}: mesh result differs from the single-device run")

    def front_back(n):
        f = prepare_reads(bench._random_reads(n, 250, 21), a1.tables)
        b = prepare_reads(bench._random_reads(n, 250, 22), a1.tables)
        return f, b

    f, b = front_back(n_dp)
    t0 = time.time()
    got = sharded_adaptor_scores(mesh, shard_reads(mesh, *f), shard_reads(mesh, *b),
                                 p1, p2, 5.0, 1.0)
    jax.block_until_ready(got)
    t_mesh = time.time() - t0
    want = sharded_adaptor_scores(solo, f, b, p1, p2, 5.0, 1.0)
    log(f"{log_prefix} sharded_adaptor_scores at {n_dp} reads: {t_mesh:.2f} s "
        f"(compilation included)")
    equal(f"sharded_adaptor_scores, {n_dp} reads", got, want)

    # The step's UMI distance block is all-pairs (O(N^2)), so it runs at a
    # size whose [N, N] block fits the card.
    f, b = front_back(n_step)
    rng = np.random.default_rng(23)
    uc = rng.integers(0, 4, (n_step, 12)).astype(np.int32)
    ul = np.full(n_step, 12, np.int32)
    got = sharded_pipeline_step(mesh, shard_reads(mesh, *f), shard_reads(mesh, *b),
                                p1, p2, *shard_reads(mesh, uc, ul), 5.0, 1.0)
    want = sharded_pipeline_step(solo, f, b, p1, p2, uc, ul, 5.0, 1.0)
    equal(f"sharded_pipeline_step, {n_step} reads", got, want)

    umis = bench.umi_inputs(n_umis=n_umi)
    pre = np.random.default_rng(24).integers(0, 64, n_umi)
    t0 = time.time()
    got = st.umi_group(umis, threshold1=2, groups=pre, mesh=mesh)
    t_mesh = time.time() - t0
    want = st.umi_group(umis, threshold1=2, groups=pre)
    log(f"{log_prefix} umi_group with 64 pre-groups at {n_umi} UMIs: {t_mesh:.2f} s")
    check(len(got) == len(want), "sharded umi_group: group counts differ")
    equal(f"umi_group with pre-groups, {n_umi} UMIs", got, want)

    adaptor1, adaptor2, batch = bench.build_workload(n_molecules=n_molecules)
    aligned = st.adaptor_align(adaptor1, adaptor2, reads=batch, tolerance=250)
    groups = st.umi_group(aligned["adaptor1"]["subseq"]["Sub2"], threshold1=2)
    fams = [g for g in groups if len(g) >= 2]
    reads = st.realize_reads(aligned, reads=batch, trim=False)
    t0 = time.time()
    msa_mesh = sharded_pregroup_msa(mesh, reads, fams, bandwidth=100)
    t_mesh = time.time() - t0
    msa_solo = st.multi_read_align(reads, groups=fams, bandwidth=100)
    log(f"{log_prefix} sharded_pregroup_msa, {len(batch)} reads in {len(fams)} "
        f"families: {t_mesh:.2f} s")
    check(list(msa_mesh["alignments"]) == list(msa_solo["alignments"]),
          "sharded_pregroup_msa differs from multi_read_align")
    log(f"{log_prefix} sharded_pregroup_msa: equal")
    cons_mesh = st.consensus_read_seq(msa_mesh, mesh=mesh)
    cons_solo = st.consensus_read_seq(msa_solo)
    check(cons_mesh.seq_strings() == cons_solo.seq_strings()
          and cons_mesh.qual_strings() == cons_solo.qual_strings(),
          "consensus_read_seq(mesh=) differs from the single-device run")
    log(f"{log_prefix} consensus_read_seq(mesh=), {len(fams)} groups: equal")


# ------------------------------------------------------------------ main


def run(cards: int) -> dict:
    import jax

    from sarlacc_tpu.parallel.mesh import make_mesh

    dev, card_list = phase_device()
    card = card_list[0]
    if cards > 1:
        check(len(jax.devices()) >= cards, f"{cards} cards asked for, "
              f"{len(jax.devices())} found")
        mesh_checks(make_mesh(cards), make_mesh(1))
        return {"platform": dev.platform, "kind": dev.device_kind, "count": cards}

    import bench

    workload = bench.build_workload()
    n_pipe = 2 * len(workload[2])  # adaptor_align stacks both orientations
    phase_compile(stage_specs(100_000, 250, n_pipe, 512, 1024))
    check_dp_align()
    check_barcodes()
    check_banded_pairs()
    check_golden_pipeline()
    phase_main(card, workload)
    from sarlacc_tpu.utils.membudget import budget_report

    log(f"[device] {budget_report()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device mesh path")
    args = ap.parse_args(argv)
    try:
        device = run(args.cards)
    except RuntimeError as e:
        if str(e).startswith("no GPU found"):
            print(f"chip_smoke: {e}", file=sys.stderr)
            return 2
        raise
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
