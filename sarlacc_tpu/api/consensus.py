"""``consensus_read_seq`` — one consensus sequence per MSA group.

Parity with R/consensusReadSeq.R:5-26 + src/create_consensus.cpp: quality
mode when the MSA frame carries qualities, basic mode otherwise; output is a
quality-scaled batch whose Phred strings follow ``errorsToString``
(create_consensus.cpp:18-32).

Groups are bucketed by (members, width) into device batches so jit shapes
stay bounded.  Two device layouts:

* **flat** (single-device default): the ragged groups travel as one
  concatenated uint8 stream + tiny descriptors and are re-padded by a
  gather on device; Phred chars come back as uint8.  This cuts the
  host<->device bytes ~5x vs the padded layout.  All buckets are
  dispatched before any readback so device work overlaps the transfers.
* **padded** (mesh path): dense [B, G, W] batches whose leading axis shards
  over the active mesh (the tally kernel is group-parallel) — the BPPARAM
  analog (R/consensusReadSeq.R runs per group under the caller's worker
  pool).  ``SARLACC_CONSENSUS_PADDED=1`` forces it single-device (parity /
  ablation).
"""

from __future__ import annotations

import os

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..core.quality import errors_to_phred_string, get_encoding
from ..ops.consensus import (
    consensus_basic_dev,
    consensus_basic_flat_dev,
    consensus_quality_dev,
    consensus_quality_flat_dev,
    quality_lut,
)
from ..utils.profiling import profiled, profiler

__all__ = ["consensus_read_seq"]

_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate("ACGTN-"):
    _CODE[ord(_b)] = _i
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _encode_msa(alignments: list[str], allow_unknown: bool):
    """MSA strings -> [G, W] int8 codes; unknown chars -> 6 or an error."""
    g = len(alignments)
    if g == 0:
        raise ValueError("alignment set must be non-empty")
    w = len(alignments[0])
    for a in alignments:
        if len(a) != w:
            raise ValueError("alignment strings should have equal width")
    raw = np.frombuffer("".join(alignments).encode(), dtype=np.uint8).reshape(g, w)
    codes = _CODE[raw]
    bad = codes < 0
    if bad.any():
        if not allow_unknown:
            ch = chr(int(raw[bad][0]))
            raise ValueError(f"unknown character '{ch}' in alignment string")
        codes = np.where(bad, np.int8(6), codes)
    return codes


def _qual_chars(codes: np.ndarray, quals: list[str], encoding) -> np.ndarray:
    """Per-read de-gapped quality chars -> per-gapped-column uint8 plane.

    Reproduces the walk of create_consensus.cpp:191-238: every non-gap column
    consumes one quality char (N included); length mismatches raise the
    reference's errors, as does a char below the encoding offset
    (quality_encoding.cpp:38-41).  Gap cells take the 255 sentinel (-> error
    probability 0.5, matching the padded path's fill).
    """
    g, w = codes.shape
    out = np.full((g, w), 255, dtype=np.uint8)
    nongap = codes != 5
    counts = nongap.sum(axis=1)
    qlens = np.fromiter((len(q) for q in quals), np.int64, count=g)
    bad = np.flatnonzero(counts != qlens)
    if bad.size:
        if counts[bad[0]] > qlens[bad[0]]:
            raise ValueError("quality vector is shorter than the alignment sequence")
        raise ValueError("quality vector is longer than the alignment sequence")
    if counts.any():
        # Non-gap column k of member i reads quality char cumsum(nongap)-1;
        # one padded [g, maxq] table turns the per-member walk into a gather.
        # Pad with the lowest encoded char: padding is never gathered (qidx
        # stays below each member's real length) but must pass validation.
        qmat = np.full((g, max(int(qlens.max()), 1)), encoding.offset, np.uint8)
        for i, q in enumerate(quals):
            qmat[i, : qlens[i]] = np.frombuffer(q.encode(), dtype=np.uint8)
        if int(qmat.min()) < encoding.offset:
            raise ValueError("quality cannot be lower than smallest encoded value")
        qidx = np.cumsum(nongap, axis=1) - 1
        rows = np.broadcast_to(np.arange(g)[:, None], (g, w))
        out[nongap] = qmat[rows[nongap], qidx[nongap]]
    return out


def _expand_quals(codes: np.ndarray, qch: np.ndarray, lut: np.ndarray):
    """Quality-char plane -> f64 error plane (padded/mesh path)."""
    return lut[qch.astype(np.int32)]


def _bucket_up(x: int) -> int:
    b = 8
    while b < x:
        b *= 2
    return b


@profiled("consensus_read_seq")
def consensus_read_seq(
    alignments: Frame | list[list[str]],
    pseudo_count: float = 1.0,
    min_coverage: float = 0.6,
    qual_type: str = "phred",
    qualities: list[list[str]] | None = None,
    mesh=None,
) -> SeqBatch:
    """Consensus per group; returns a quality-scaled SeqBatch (Phred+33)."""
    if isinstance(alignments, Frame):
        groups = list(alignments["alignments"])
        quals = list(alignments["qualities"]) if "qualities" in alignments else None
        names = alignments.rownames
    else:
        groups = list(alignments)
        quals = qualities
        names = None
    has_quals = quals is not None
    encoding = get_encoding(qual_type)
    lut = quality_lut(encoding)

    ngroups = len(groups)
    with profiler("consensus.encode"):
        enc = [_encode_msa(g, allow_unknown=has_quals) for g in groups]
        qch = (
            [_qual_chars(c, q, encoding) for c, q in zip(enc, quals)]
            if has_quals
            else [None] * ngroups
        )

    # Bucket by padded shape.
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, c in enumerate(enc):
        key = (_bucket_up(c.shape[0]), _bucket_up(max(c.shape[1], 1)))
        buckets.setdefault(key, []).append(i)

    seqs: list[str] = [""] * ngroups
    phreds: list[str] = [""] * ngroups
    #: Byte budget for one launch's device planes (the [B, G, W] codes/eps
    #: intermediates).  Chunks are pow2-padded so the compile count stays
    #: bounded.  The 64 MiB flat cap was chosen on earlier hardware and has
    #: not yet been measured on the GPU.
    use_flat = mesh is None and not os.environ.get("SARLACC_CONSENSUS_PADDED")
    CHUNK_BYTES = (64 << 20) if use_flat else (256 << 20)
    inflight: list = []
    for (gpad, wpad), all_idxs in buckets.items():
        cb = max(16, CHUNK_BYTES // (gpad * wpad * (8 if mesh else 4)))
        p2 = 16
        while p2 * 2 <= cb:
            p2 *= 2
        for c0 in range(0, len(all_idxs), p2):
            idxs = all_idxs[c0 : c0 + p2]
            bcap = min(p2, _bucket_up(len(idxs)))
            if use_flat:
                inflight.append(
                    _dispatch_flat_chunk(
                        idxs, gpad, wpad, bcap, enc, qch, has_quals, lut,
                        min_coverage, pseudo_count,
                    )
                )
            else:
                _consensus_chunk(
                    idxs, gpad, wpad, bcap, enc, qch, has_quals, lut, mesh,
                    min_coverage, pseudo_count, seqs, phreds,
                )
    # Flat path: every chunk is queued on device; read back only now,
    # overlapped with the later chunks' device work.
    for item in inflight:
        _collect_flat_chunk(item, enc, seqs, phreds)

    out = SeqBatch.from_strings(seqs, phreds, names)
    return out


def _dispatch_flat_chunk(
    idxs, gpad, wpad, bcap, enc, qch, has_quals, lut, min_coverage,
    pseudo_count,
):
    """Queue one flat-layout consensus launch (async); returns the handles."""
    import jax.numpy as jnp

    with profiler("consensus.pack"):
        b = bcap
        gstart = np.zeros(b, np.int32)
        widths = np.zeros(b, np.int32)
        naligns = np.zeros(b, np.int32)
        at = 0
        parts_c = []
        parts_q = []
        for k, i in enumerate(idxs):
            g, w = enc[i].shape
            gstart[k] = at
            widths[k] = w
            naligns[k] = g
            parts_c.append(enc[i].reshape(-1))
            if has_quals:
                parts_q.append(qch[i].reshape(-1))
            at += g * w
        F = _bucket_up(max(at, 1))
        flat_c = np.full(F, 5, np.int8)
        if parts_c:
            flat_c[:at] = np.concatenate(parts_c)
        if has_quals:
            flat_q = np.full(F, 255, np.uint8)
            if parts_q:
                flat_q[:at] = np.concatenate(parts_q)
    with profiler("consensus.dispatch"):
        if has_quals:
            keep, best, qc = consensus_quality_flat_dev(
                flat_c, flat_q, lut, gstart, widths, naligns,
                float(min_coverage), G=gpad, W=wpad,
            )
        else:
            keep, best, qc = consensus_basic_flat_dev(
                flat_c, gstart, widths, naligns, float(min_coverage),
                float(pseudo_count), G=gpad, W=wpad,
            )
    return idxs, keep, best, qc


def _collect_flat_chunk(item, enc, seqs, phreds):
    idxs, keep_dev, best_dev, qc_dev = item
    with profiler("consensus.readback"):
        keep = np.asarray(keep_dev)
        best = np.asarray(best_dev)
        qc = np.asarray(qc_dev)
    with profiler("consensus.assemble"):
        for k, i in enumerate(idxs):
            w = enc[i].shape[1]
            cols = np.flatnonzero(keep[k, :w])
            seqs[i] = _BASES[best[k, cols]].tobytes().decode()
            phreds[i] = qc[k, cols].tobytes().decode()


def _consensus_chunk(
    idxs, gpad, wpad, bcap, enc, qch, has_quals, lut, mesh, min_coverage,
    pseudo_count, seqs, phreds,
):
    """One bounded padded-layout launch (mesh path); writes into seqs/phreds."""
    from ..parallel.context import pad_to_mesh, use_mesh, shard_batch

    # Padded groups are all-gap with naligns=0; their outputs are never
    # read (only the first len(idxs) batch rows are consumed below).
    b = pad_to_mesh(max(bcap, len(idxs)), mesh)
    codes = np.full((b, gpad, wpad), 5, dtype=np.int8)
    naligns = np.zeros(b, dtype=np.int32)
    epsb = np.full((b, gpad, wpad), 0.5, dtype=np.float64)
    for k, i in enumerate(idxs):
        g, w = enc[i].shape
        codes[k, :g, :w] = enc[i]
        naligns[k] = g
        if has_quals:
            epsb[k, :g, :w] = _expand_quals(enc[i], qch[i], lut)
    with use_mesh(mesh):
        if has_quals:
            codes, epsb, naligns = shard_batch(codes, epsb, naligns)
            keep, best, err = consensus_quality_dev(
                codes, epsb, naligns, float(min_coverage)
            )
        else:
            codes, naligns = shard_batch(codes, naligns)
            keep, best, err = consensus_basic_dev(
                codes, naligns, float(min_coverage), float(pseudo_count)
            )
    keep = np.asarray(keep)
    best = np.asarray(best)
    err = np.asarray(err, dtype=np.float64)
    for k, i in enumerate(idxs):
        w = enc[i].shape[1]
        cols = np.flatnonzero(keep[k, :w])
        seqs[i] = _BASES[best[k, cols]].tobytes().decode()
        phreds[i] = errors_to_phred_string(err[k, cols])
