"""``adaptor_align`` — align both adaptors to every read, canonical orientation.

Batched re-design of the reference's main entry point (R/adaptorAlign.R:7-77):
the FASTQ streams in fixed-size chunks; per chunk the first/last
``tolerance`` bases (back reverse-complemented) are batch-aligned against
adaptor1 and adaptor2 in both orientations — two stacked device launches
over the whole chunk instead of four C++ calls per worker shard — the strand is
resolved by clamped combined score, rows are swapped into canonical
orientation, and adaptor2 coordinates are flipped onto the forward strand.

Output schema (parity with R/adaptorAlign.R:62-77): a Frame with columns
``read.width``, ``adaptor1`` (nested: score/start/end/subseq), ``adaptor2``
(same, coordinates flipped to canonical orientation), ``reversed``; rownames
are read names; metadata carries filepath, qual.type and tolerance, and each
adaptor frame's metadata carries its sequence and gap penalties.
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..io.fastq import stream_fastq
from ..utils.profiling import profiled
from .align_internal import (
    align_and_extract,
    prepare_adaptor,
    resolve_strand,
)

__all__ = ["adaptor_align"]

QUAL_TYPES = ("phred", "solexa", "illumina")


@profiled("adaptor_align")
def adaptor_align(
    adaptor1: str,
    adaptor2: str,
    filepath: str | None = None,
    reads: SeqBatch | None = None,
    tolerance: int = 250,
    gap_opening: float = 5,
    gap_extension: float = 1,
    qual_type: str = "phred",
    number: int = 100_000,
    mesh=None,
) -> Frame:
    """Align adaptors to read ends and standardize read orientation.

    Either ``filepath`` (streamed in ``number``-read chunks,
    R/adaptorAlign.R:26-36) or an in-memory ``reads`` batch must be given.
    Pass a ``jax.sharding.Mesh`` as ``mesh`` to shard each chunk's batch
    over devices (data parallelism over reads, SURVEY.md §2.3).
    """
    if qual_type not in QUAL_TYPES:
        raise ValueError(f"qual_type must be one of {QUAL_TYPES}")
    adaptor1 = adaptor1.upper()
    adaptor2 = adaptor2.upper()
    a1 = prepare_adaptor(adaptor1, qual_type)
    a2 = prepare_adaptor(adaptor2, qual_type)

    if (filepath is None) == (reads is None):
        raise ValueError("exactly one of filepath or reads must be supplied")

    # Each chunk launches STACKED (front+back interleavings), so the device
    # batch is 2x the chunk size; stride at number//2 to keep every launch
    # at the `number`-read width the demux/score paths already validate.
    # (One unchunked 500k in-memory batch would ask the dirs path for a
    # ~130 GB cost-plane gather; R/adaptorAlign.R:26-36 streams for the
    # same reason.)
    stride = max(1, number // 2)
    if reads is not None:
        if len(reads) > stride:
            chunks = (
                reads.take(np.arange(c0, min(c0 + stride, len(reads))))
                for c0 in range(0, len(reads), stride)
            )
            pad_n = stride
        else:
            chunks = [reads]
            pad_n = None
    else:
        chunks = stream_fastq(filepath, chunk_size=stride)
        pad_n = stride

    starts_parts: list[Frame] = []
    ends_parts: list[Frame] = []
    rev_parts: list[np.ndarray] = []
    width_parts: list[np.ndarray] = []
    names: list[str] = []

    nchunks = 0
    for batch in chunks:
        nchunks += 1
        front, back = batch.front_and_back(tolerance)
        nb = len(batch)

        # Both orientations of one adaptor share the reference, so they run
        # as ONE device launch on the stacked batch (halves launch count).
        fb = SeqBatch.concat([front, back])
        bf = SeqBatch.concat([back, front])
        res1 = align_and_extract(
            a1, fb, gap_opening, gap_extension, 2 * pad_n if pad_n else None,
            mesh=mesh,
        )
        res2 = align_and_extract(
            a2, bf, gap_opening, gap_extension, 2 * pad_n if pad_n else None,
            mesh=mesh,
        )
        lo = np.arange(nb)
        hi = np.arange(nb, 2 * nb)
        cur_starts = res1.take(lo)
        cur_rc_starts = res1.take(hi)
        cur_ends = res2.take(lo)
        cur_rc_ends = res2.take(hi)

        is_reverse, _ = resolve_strand(
            cur_starts["score"],
            cur_ends["score"],
            cur_rc_starts["score"],
            cur_rc_ends["score"],
        )
        ridx = np.flatnonzero(is_reverse)
        fidx = np.flatnonzero(~is_reverse)
        order = np.argsort(np.concatenate([fidx, ridx]), kind="stable")
        if len(ridx):
            cur_starts = Frame.rbind(
                [cur_starts.take(fidx), cur_rc_starts.take(ridx)]
            ).take(order)
            cur_ends = Frame.rbind(
                [cur_ends.take(fidx), cur_rc_ends.take(ridx)]
            ).take(order)

        starts_parts.append(cur_starts)
        ends_parts.append(cur_ends)
        rev_parts.append(is_reverse)
        width_parts.append(batch.lengths.astype(np.int64))
        names.extend(batch.names or [f"read_{len(names) + i + 1}" for i in range(len(batch))])

    if nchunks == 0:
        empty = SeqBatch.from_strings([], [])
        return adaptor_align(
            adaptor1,
            adaptor2,
            reads=empty,
            tolerance=tolerance,
            gap_opening=gap_opening,
            gap_extension=gap_extension,
            qual_type=qual_type,
        )

    align_start = Frame.rbind(starts_parts)
    align_end = Frame.rbind(ends_parts)
    widths = np.concatenate(width_parts)
    reversed_ = np.concatenate(rev_parts)

    details = {"gapOpening": gap_opening, "gapExtension": gap_extension}
    align_start.metadata = {"sequence": adaptor1, **details}
    align_end.metadata = {"sequence": adaptor2, **details}

    # Adaptor2 coordinates onto the forward strand (R/adaptorAlign.R:66-71).
    old_start = align_end["start"].astype(np.int64)
    old_end = align_end["end"].astype(np.int64)
    align_end["start"] = (widths - old_start + 1).astype(np.int32)
    align_end["end"] = (widths - old_end + 1).astype(np.int32)

    out = Frame(
        {
            "read.width": widths.astype(np.int32),
            "adaptor1": align_start,
            "adaptor2": align_end,
            "reversed": reversed_,
        },
        metadata={
            "filepath": filepath,
            "qual.type": qual_type,
            "tolerance": tolerance,
        },
        rownames=names,
    )
    return out
