"""Internal batched alignment driver shared by the adaptor-facing APIs.

Device equivalent of ``.align_and_extract`` / ``.align_AA_internal``
(R/adaptorAlign.R:151-199) and the C driver loop
(src/adaptor_align.cpp:45-69): one ``dp_align`` launch covers the whole
batch, after which coordinate maps are backtracked on the host.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.encode import SeqBatch, iupac_reference
from ..core.frame import Frame
from ..core.scoring import ScoreTables, build_score_tables
from ..ops.align import dp_align, prepare_reads, prepare_reference
from ..ops.backtrack import qmap_walk_device, query_windows

__all__ = [
    "PreparedAdaptor",
    "prepare_adaptor",
    "setup_subseqs",
    "align_and_extract",
    "align_scores_only",
    "resolve_strand",
]


def setup_subseqs(adaptor: str):
    """Ambiguous stretches ``[^ACTG]+`` of the adaptor (R/adaptorAlign.R:136-143).

    Returns (starts, ends), both 1-based inclusive.
    """
    starts, ends = [], []
    for m in re.finditer("[^ACTG]+", adaptor):
        starts.append(m.start() + 1)
        ends.append(m.end())
    return starts, ends


@dataclass
class PreparedAdaptor:
    """An adaptor with its device-side scoring arrays and section layout."""

    seq: str
    modes: jnp.ndarray
    matched: jnp.ndarray
    match_tab: jnp.ndarray
    mismatch_tab: jnp.ndarray
    sec_starts: list[int]
    sec_ends: list[int]
    tables: ScoreTables

    def __len__(self):
        return len(self.seq)


def prepare_adaptor(
    adaptor: str, qual_type: str = "phred", dtype=jnp.float32
) -> PreparedAdaptor:
    adaptor = adaptor.upper()
    tables = build_score_tables(qual_type)
    modes, matched, mt, mmt = prepare_reference(
        iupac_reference(adaptor), tables, dtype=dtype
    )
    starts, ends = setup_subseqs(adaptor)
    return PreparedAdaptor(adaptor, modes, matched, mt, mmt, starts, ends, tables)


def _shard(mesh, *arrays):
    """Shard batch-major device inputs over the mesh's reads axis; XLA then
    partitions every batch-parallel kernel without further annotation."""
    if mesh is None:
        return arrays
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def _pad_batch(batch: SeqBatch, pad_n: int | None) -> tuple[SeqBatch, int]:
    """Pad the batch to a fixed row count so jit shapes stay stable."""
    n = len(batch)
    if pad_n is None or pad_n <= n:
        return batch, n
    extra = pad_n - n
    codes = np.concatenate(
        [batch.codes, np.full((extra, batch.width), 5, np.int8)], axis=0
    )
    lengths = np.concatenate([batch.lengths, np.zeros(extra, np.int32)])
    quals = None
    if batch.quals is not None:
        quals = np.concatenate(
            [batch.quals, np.zeros((extra, batch.width), np.uint8)], axis=0
        )
    return SeqBatch(codes, lengths, quals, None), n


class PreparedReads(NamedTuple):
    """A device-resident read batch for repeated score-only launches.

    The tuning grid re-scores the same front/back batches 2 x 35 times
    (R/tuneAlignment.R:54-72) and demux scores one batch against every
    barcode, so the [N, L] codes/qidx arrays are uploaded once.  Unpacks as
    ``(codes, qidx, lengths), n``.
    """

    arrays: tuple
    n: int


def prepare_scores_input(
    adaptor: PreparedAdaptor,
    batch: SeqBatch,
    pad_n: int | None = None,
    mesh=None,
) -> PreparedReads:
    """Upload a batch once for repeated score-only launches."""
    if mesh is not None:
        m = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        pad_n = ((max(pad_n or 0, len(batch)) + m - 1) // m) * m
    padded, n = _pad_batch(batch, pad_n)
    codes, qidx, lengths = prepare_reads(padded, adaptor.tables)
    return PreparedReads(_shard(mesh, codes, qidx, lengths), n)


def align_scores_only(
    adaptor: PreparedAdaptor,
    batch: SeqBatch,
    gap_opening: float,
    gap_extension: float,
    pad_n: int | None = None,
    mesh=None,
    prepared=None,
    local: bool = True,
    as_device: bool = False,
):
    """Batch fitting-mode scores (src/adaptor_align.cpp:79-110).

    Pass ``prepared`` from :func:`prepare_scores_input` to reuse one device
    upload across many launches.  ``as_device=True`` returns the [n] device
    array so callers can stack several score vectors and read back once;
    the default returns float64 numpy.
    """
    if prepared is None:
        prepared = prepare_scores_input(adaptor, batch, pad_n, mesh)
    (codes, qidx, lengths), n = prepared
    from ..utils.profiling import profiler

    cells = int(codes.shape[0]) * int(codes.shape[1]) * len(adaptor)
    with profiler("align.score_only", items=n, cells=cells):
        scores, _ = dp_align(
            codes,
            qidx,
            lengths,
            adaptor.modes,
            adaptor.matched,
            adaptor.match_tab,
            adaptor.mismatch_tab,
            float(gap_opening),
            float(gap_extension),
            local=local,
            need_directions=False,
        )
        if as_device:
            return scores[:n]
        return np.asarray(scores)[:n].astype(np.float64)


def align_and_extract(
    adaptor: PreparedAdaptor,
    batch: SeqBatch,
    gap_opening: float,
    gap_extension: float,
    pad_n: int | None = None,
    mesh=None,
) -> Frame:
    """Scores, read-coordinate spans, and per-section subsequences.

    Mirrors src/adaptor_align.cpp:45-75 + R/adaptorAlign.R:151-175: spans are
    1-based inclusive; empty alignments report start=end=0; section
    subsequences include flanking gaps (querymap include_gaps=True).
    """
    if mesh is not None:
        m = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        pad_n = ((max(pad_n or 0, len(batch)) + m - 1) // m) * m
    padded, n = _pad_batch(batch, pad_n)
    codes, qidx, lengths = prepare_reads(padded, adaptor.tables)
    codes, qidx, lengths = _shard(mesh, codes, qidx, lengths)
    from ..utils.profiling import profiler

    cells = int(codes.shape[0]) * int(codes.shape[1]) * len(adaptor)
    with profiler("align.fit", items=n, cells=cells):
        scores, dirs = dp_align(
            codes,
            qidx,
            lengths,
            adaptor.modes,
            adaptor.matched,
            adaptor.match_tab,
            adaptor.mismatch_tab,
            float(gap_opening),
            float(gap_extension),
            local=True,
            need_directions=True,
        )
        scores = np.asarray(scores)[:n].astype(np.float64)

    # Backtrack on device: the direction tensor never leaves device memory;
    # only the [N, R+1] mapping arrays transfer.
    rlen = len(adaptor)
    om_d, orow_d = qmap_walk_device(dirs, lengths)
    is_match = np.asarray(om_d)[:n]
    dp_row = np.asarray(orow_d)[:n]
    nrows = batch.lengths.astype(np.int64) + 1

    s0, e0 = query_windows(is_match, dp_row, nrows, 0, rlen)
    ok = s0 < e0  # empty-sequence guard (adaptor_align.cpp:59)
    starts = np.where(ok, s0 + 1, 0).astype(np.int32)
    ends = np.where(ok, e0, 0).astype(np.int32)

    nsec = len(adaptor.sec_starts)
    sec_start = np.zeros((nsec, n), dtype=np.int32)
    sec_width = np.zeros((nsec, n), dtype=np.int32)
    for k in range(nsec):
        cs, ce = query_windows(
            is_match, dp_row, nrows,
            adaptor.sec_starts[k] - 1, adaptor.sec_ends[k], include_gaps=True,
        )
        sec_start[k] = cs + 1
        sec_width[k] = ce - cs

    out = Frame(score=scores, start=starts, end=ends)
    if nsec:
        segs = {}
        for k in range(nsec):
            s1 = sec_start[k].astype(np.int64)
            segs[f"Sub{k + 1}"] = batch.subseq(s1, s1 + sec_width[k] - 1)
        out["subseq"] = Frame(segs)
    else:
        out["subseq"] = Frame(nrow=n)
    return out


def resolve_strand(
    start_score: np.ndarray,
    end_score: np.ndarray,
    rc_start_score: np.ndarray,
    rc_end_score: np.ndarray,
):
    """R/adaptorAlign.R:112-122: orientation by clamped combined score."""
    fscore = np.maximum(start_score, 0) + np.maximum(end_score, 0)
    rscore = np.maximum(rc_start_score, 0) + np.maximum(rc_end_score, 0)
    is_reverse = fscore < rscore
    final = np.where(is_reverse, rscore, fscore)
    return is_reverse, final
