"""Barcode demultiplexing — ``barcode_align`` / ``get_barcode_thresholds``.

Parity with R/barcodeAlign.R + src/barcode_align.cpp: every observed barcode
subsequence is **globally** aligned (quality-aware) against each reference
barcode in one device launch; best and second-best scores give the assignment
and its gap.  Thresholds are median − nmads·MAD (R/getBarcodeThresholds.R).
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from .align_internal import prepare_adaptor
from ..utils.profiling import profiled

__all__ = ["barcode_align", "get_barcode_thresholds"]


@profiled("barcode_align")
def barcode_align(
    sequences: SeqBatch,
    barcodes: list[str],
    gap_opening: float = 5,
    gap_extension: float = 1,
    qual_type: str = "phred",
    mesh=None,
) -> Frame:
    """Assign each sequence to its best-scoring barcode.

    Returns Frame(barcode, score, gap) where ``barcode`` is the 0-based index
    of the winner (the reference reports 1-based), ``gap`` the margin over the
    runner-up; metadata carries penalties and the barcode list.  ``mesh``
    shards the sequence batch over devices — the BPPARAM analog
    (R/barcodeAlign.R:4, workers dispatched at :22-24).
    """
    n = len(sequences)
    current_score = np.full(n, -np.inf)
    next_best = np.full(n, -np.inf)
    current_id = np.full(n, -1, dtype=np.int64)

    preps = [prepare_adaptor(str(seq).upper(), qual_type) for seq in barcodes]
    if preps:
        # One read upload shared by every barcode launch (the quality table
        # is per qual_type, not per barcode), then device-side best and
        # second-best so only three [n] vectors are read back instead of
        # one [n] per barcode.
        import jax.numpy as jnp

        from .align_internal import align_scores_only, prepare_scores_input

        prepared = prepare_scores_input(preps[0], sequences, mesh=mesh)
        per_bc = [
            align_scores_only(
                prep, None, gap_opening, gap_extension,
                prepared=prepared, local=False, as_device=True,
            )
            for prep in preps
        ]
        stack = jnp.stack(per_bc)  # [B, n]
        best_id = jnp.argmax(stack, axis=0)  # first max wins ties, as the
        # sequential `scores > current_score` walk did (R/barcodeAlign.R:27-38)
        best = jnp.take_along_axis(stack, best_id[None, :], axis=0)[0]
        masked = jnp.where(
            jnp.arange(len(preps))[:, None] == best_id[None, :], -jnp.inf, stack
        )
        second = jnp.max(masked, axis=0)
        packed = np.asarray(
            jnp.stack([best_id.astype(best.dtype), best, second])
        ).astype(np.float64)  # one readback
        current_id = packed[0].astype(np.int64)
        current_score = packed[1]
        next_best = packed[2]

    out = Frame(
        barcode=current_id,
        score=current_score,
        gap=current_score - next_best,
    )
    out.metadata = {
        "gapOpening": gap_opening,
        "gapExtension": gap_extension,
        "barcodes": list(barcodes),
    }
    return out


def _mad(x: np.ndarray, center: float) -> float:
    """R's mad() with the default 1.4826 consistency constant."""
    return 1.4826 * float(np.median(np.abs(x - center)))


def get_barcode_thresholds(baligned: Frame, nmads: float = 3) -> dict:
    """median − nmads·MAD thresholds on score and gap (R/getBarcodeThresholds.R:10-14)."""
    score = np.asarray(baligned["score"], dtype=np.float64)
    gap = np.asarray(baligned["gap"], dtype=np.float64)
    med_s = float(np.median(score))
    med_g = float(np.median(gap))
    return {
        "score": med_s - _mad(score, med_s) * nmads,
        "gap": med_g - _mad(gap, med_g) * nmads,
    }
