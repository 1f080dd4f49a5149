"""``quality_align`` — batch global quality-aware alignment to one reference.

Parity with R/qualityAlign.R + src/general_align.cpp: global mode, returns
scores, edit distances (count of differing alignment columns, gaps
included), and optionally the gapped reference/query strings.
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..ops.align import dp_align, prepare_reads
from ..ops.backtrack import assemble_strings, string_walk_device
from .align_internal import prepare_adaptor
from ..utils.profiling import profiled

__all__ = ["quality_align"]


@profiled("quality_align")
def quality_align(
    sequences: SeqBatch,
    reference: str,
    gap_opening: float = 5,
    gap_extension: float = 1,
    edit_only: bool = False,
    qual_type: str = "phred",
) -> Frame:
    ref = str(reference).upper()
    prep = prepare_adaptor(ref, qual_type)
    codes, qidx, lengths = prepare_reads(sequences, prep.tables)
    scores, dirs = dp_align(
        codes,
        qidx,
        lengths,
        prep.modes,
        prep.matched,
        prep.match_tab,
        prep.mismatch_tab,
        float(gap_opening),
        float(gap_extension),
        local=False,
        need_directions=True,
    )
    scores = np.asarray(scores, dtype=np.float64)

    # Backtrack on device: the [R, N, L+1] direction tensor never leaves
    # device memory; only the [N, R+L+1] emission arrays transfer
    # (R*L >> R+L).
    seq_strs = sequences.seq_strings()
    a_pos, b_pos, ncols = string_walk_device(dirs, lengths)
    refalign, qalign, edits = assemble_strings(
        a_pos, b_pos, ncols, ref, seq_strs
    )

    cols = {"score": scores, "edit": edits}
    if not edit_only:
        cols["reference"] = refalign
        cols["query"] = qalign
    out = Frame(cols)
    out.metadata = {
        "gapOpening": gap_opening,
        "gapExtension": gap_extension,
        "reference": reference,
    }
    return out
