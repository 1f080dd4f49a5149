"""Host-side backtracking over batched run-length direction tensors.

The device DP kernel (:mod:`.align`) emits, per read, the same run-length
direction encoding as the reference (0 diagonal, +k left-run, -k up-run;
reference_align.cpp:162-174), stacked as ``dirs[R, N, L+1]`` for reference
columns 1..R.  This module replays the reference's template backtrack
(reference_align.cpp:231-278) over that tensor to produce either

* **query maps** — per reference position, whether it was matched and the DP
  row reached (reference_align.cpp:280-305), queried through
  :class:`~sarlacc_tpu.refimpl.align.QueryMap` semantics; or
* **gapped alignment strings** (reference_align.cpp:353-389).

Plain NumPy loops per read; a C++ fast path may shadow this later.  Each
read's walk is O(L + R) so even 1e5 reads are cheap relative to the DP.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..refimpl.align import QueryMap

__all__ = [
    "backtrack_map",
    "backtrack_maps",
    "backtrack_strings",
    "qmap_walk_device",
    "query_windows",
    "string_walk_device",
    "assemble_strings",
]


def _dir_fetch(dirs):
    """(R, N, walk-step budget, fetch(col, row) -> [N] int32) over the
    ``[R, N, L+1]`` direction tensor."""
    R, N, L1 = dirs.shape
    flat = dirs.transpose(1, 0, 2).reshape(N, R * L1)  # [N, R*L1]

    def fetch(col, row):
        idx = jnp.clip((col - 1) * L1 + row, 0, R * L1 - 1)
        return jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0].astype(
            jnp.int32
        )

    return R, N, L1, fetch


@jax.jit
def qmap_walk_device(dirs, lengths):
    """Batched on-device replay of the template backtrack -> query maps.

    The direction tensor stays in device memory; only the small
    per-reference-position mapping arrays come back to the host, instead of
    the full [R, N, L+1] int16 tensor.

    Returns (is_match [N, R+1] bool, dp_row [N, R+1] int32), exactly the
    ``fill_map`` mapping (reference_align.cpp:280-305): position 0 is the
    initial (False, 0); diag cells record (True, row); left-run cells record
    (False, row+1); up-runs record nothing.
    """
    R, N, L1, fetch = _dir_fetch(dirs)
    narr = jnp.arange(N)

    col0 = jnp.full(N, R, jnp.int32)
    row0 = jnp.asarray(lengths, jnp.int32)
    rc0 = jnp.zeros(N, jnp.int32)
    om0 = jnp.zeros((N, R + 2), jnp.bool_)
    or0 = jnp.zeros((N, R + 2), jnp.int32)

    def cond(carry):
        col, row, rc, om, orow, it = carry
        return jnp.logical_and(jnp.any(col > 0), it < R + L1 + 4)

    def step(carry):
        col, row, rc, om, orow, it = carry
        active = col > 0
        d = fetch(col, row)

        up = active & (rc == 0) & (row > 0) & (d < 0)
        diag = active & (rc == 0) & ~up & (d == 0)
        left_new = active & (rc == 0) & ~up & (d > 0)
        left_cont = active & (rc > 0)
        write = diag | left_new | left_cont

        wcol = jnp.where(write, col, R + 1)  # R+1 slot is a scratch bin
        wmatch = diag
        wrow = jnp.where(diag, row, row + 1)
        om = om.at[narr, wcol].set(wmatch)
        orow = orow.at[narr, wcol].set(wrow)

        row = jnp.where(up, row + d, jnp.where(diag, row - 1, row))
        rc = jnp.where(left_new, d - 1, jnp.where(left_cont, rc - 1, rc))
        col = jnp.where(diag | left_new | left_cont, col - 1, col)
        return col, row, rc, om, orow, it + 1

    def multi_step(carry):
        # 8 walk steps per while iteration: finished reads no-op, and each
        # loop iteration carries a fixed launch-and-test cost.
        return jax.lax.fori_loop(0, 8, lambda _, c: step(c), carry)

    _, _, _, om, orow, _ = jax.lax.while_loop(
        cond, multi_step, (col0, row0, rc0, om0, or0, jnp.int32(0))
    )
    return om[:, : R + 1], orow[:, : R + 1]


def query_windows(
    is_match: np.ndarray,
    dp_row: np.ndarray,
    nrows: np.ndarray,
    ref_start: int,
    ref_end: int,
    include_gaps: bool = False,
):
    """Vectorized ``querymap::operator()`` over all reads
    (reference_align.cpp:307-351).  Returns (starts, ends), 0-based."""
    R = is_match.shape[1] - 1
    if R == 0:
        z = np.zeros(is_match.shape[0], np.int64)
        return z, z
    if not include_gaps:
        curstart = dp_row[:, ref_start + 1].astype(np.int64)
        curend = dp_row[:, ref_end].astype(np.int64) + is_match[:, ref_end]
        return curstart - 1, curend - 1
    if ref_start == 0:
        curstart = np.ones(is_match.shape[0], np.int64)
    else:
        curstart = dp_row[:, ref_start].astype(np.int64) + is_match[:, ref_start]
    e2 = ref_end + 1
    if e2 == R + 1:
        curend = np.asarray(nrows, np.int64)
    else:
        curend = dp_row[:, e2].astype(np.int64)
    return curstart - 1, curend - 1


@jax.jit
def string_walk_device(dirs, lengths):
    """Batched on-device replay of the template backtrack -> gapped strings.

    The direction tensor stays in device memory; per read only two [T] int16 emission
    arrays (T = R + L + 1) come back: position t holds the reference
    position (0 = gap) and query position (0 = gap) of the t-th alignment
    column FROM THE END (the walk runs backwards,
    reference_align.cpp:353-389).  Decode with :func:`assemble_strings`.

    Returns (a_pos [N, T] int16, b_pos [N, T] int16, ncols [N] int32).
    """
    R, N, L1, fetch = _dir_fetch(dirs)
    T = R + L1 + 1
    narr = jnp.arange(N)

    col0 = jnp.full(N, R, jnp.int32)
    row0 = jnp.asarray(lengths, jnp.int32)
    z = jnp.zeros(N, jnp.int32)
    oa0 = jnp.zeros((N, T + 1), jnp.int16)
    ob0 = jnp.zeros((N, T + 1), jnp.int16)

    def cond(c):
        col, row, rc, uc, t, oa, ob, it = c
        return jnp.logical_and(
            jnp.any(jnp.logical_or(col > 0, row > 0)), it < T + 8
        )

    def step(c):
        col, row, rc, uc, t, oa, ob, it = c
        active = jnp.logical_or(col > 0, row > 0)
        d = fetch(col, row)

        fresh = active & (rc == 0) & (uc == 0)
        tailq = fresh & (col == 0)  # i exhausted: trailing query columns
        see_up = fresh & ~tailq & (row > 0) & (d < 0)
        diag = fresh & ~tailq & ~see_up & (d == 0)
        newl = fresh & ~tailq & ~see_up & (d > 0)

        uc2 = jnp.where(see_up, -d, uc)
        rc2 = jnp.where(newl, d, rc)

        emit_up = active & (uc2 > 0) & ~diag & ~newl & ~tailq
        emit_left = active & (rc2 > 0) & ~emit_up & ~diag & ~tailq

        # Exactly one emission per active read per step.
        wa = jnp.where(emit_left | diag, col, 0).astype(jnp.int16)
        wb = jnp.where(emit_up | tailq | diag, row, 0).astype(jnp.int16)
        slot = jnp.where(active, jnp.clip(t, 0, T), T)
        oa = oa.at[narr, slot].set(wa)
        ob = ob.at[narr, slot].set(wb)

        row = row - (emit_up | tailq | diag)
        col = col - (emit_left | diag)
        uc = uc2 - emit_up
        rc = rc2 - emit_left
        t = t + active
        return col, row, rc, uc, t, oa, ob, it + 1

    def multi_step(c):
        return jax.lax.fori_loop(0, 8, lambda _, x: step(x), c)

    _, _, _, _, t, oa, ob, _ = jax.lax.while_loop(
        cond, multi_step, (col0, row0, z, z, z, oa0, ob0, jnp.int32(0))
    )
    return oa[:, :T], ob[:, :T], t


def assemble_strings(a_pos, b_pos, ncols, refseq: str, seqs: list[str]):
    """Emission arrays -> gapped (reference, query) strings + edit counts.

    Vectorized decode of :func:`string_walk_device`'s output: one fancy-index
    per side builds [N, T] byte planes; per read the first ``ncols`` bytes,
    reversed, are the alignment (the walk emits back-to-front).  Edits count
    differing columns (general_align.cpp:47-52).
    """
    a_pos = np.asarray(a_pos, dtype=np.int64)
    b_pos = np.asarray(b_pos, dtype=np.int64)
    ncols = np.asarray(ncols, dtype=np.int64)
    N, T = a_pos.shape
    rbytes = np.frombuffer(("-" + refseq).encode(), dtype=np.uint8)
    ra = rbytes[a_pos]  # [N, T] uint8
    maxq = max((len(s) for s in seqs), default=0)
    qmat = np.full((N, maxq + 1), ord("-"), np.uint8)
    for i, s in enumerate(seqs):
        if s:
            qmat[i, 1 : len(s) + 1] = np.frombuffer(s.encode(), dtype=np.uint8)
    qa = qmat[np.arange(N)[:, None], np.clip(b_pos, 0, maxq)]
    qa[b_pos == 0] = ord("-")

    live = np.arange(T)[None, :] < ncols[:, None]
    edits = ((ra != qa) & live).sum(axis=1).astype(np.int64)
    refalign = [ra[i, : ncols[i]][::-1].tobytes().decode() for i in range(N)]
    qalign = [qa[i, : ncols[i]][::-1].tobytes().decode() for i in range(N)]
    return refalign, qalign, edits


def backtrack_map(dirs_nr: np.ndarray, rlen: int) -> QueryMap:
    """One read's ``fill_map`` from its [R, L+1] direction matrix."""
    nrows = dirs_nr.shape[1]
    mapping = [(False, 0)] * (rlen + 1)

    col = rlen
    currow = nrows - 1
    i = rlen
    while i > 0:
        while currow > 0:
            curdir = int(dirs_nr[col - 1, currow])
            if curdir >= 0:
                break
            currow += curdir  # consume the whole up-run

        curdir = int(dirs_nr[col - 1, currow])
        if curdir == 0:
            mapping[i] = (True, currow)
            currow -= 1
            col -= 1
            i -= 1
        else:
            for _ in range(curdir):
                mapping[i] = (False, currow + 1)
                i -= 1
                col -= 1
    return QueryMap(mapping, nrows)


def backtrack_maps(dirs: np.ndarray, lengths: np.ndarray, rlen: int) -> list[QueryMap]:
    """All reads' query maps.

    ``dirs`` is [R, N, L+1] (device layout); each read only uses rows
    0..length, so the direction matrix is sliced per read.
    """
    dirs = np.asarray(dirs)
    out = []
    for n in range(dirs.shape[1]):
        nrows = int(lengths[n]) + 1
        out.append(backtrack_map(dirs[:, n, :nrows], rlen))
    return out


def backtrack_strings(
    dirs_nr: np.ndarray, rlen: int, refseq: str, qseq: str
) -> tuple[str, str]:
    """One read's gapped (reference, query) strings (reference_align.cpp:353-389)."""
    nrows = dirs_nr.shape[1]
    rwork: list[str] = []
    qwork: list[str] = []

    col = rlen
    currow = nrows - 1
    i = rlen
    while i > 0:
        while currow > 0:
            curdir = int(dirs_nr[col - 1, currow])
            if curdir >= 0:
                break
            while curdir < 0:
                rwork.append("-")
                qwork.append(qseq[currow - 1])
                currow -= 1
                curdir += 1

        curdir = int(dirs_nr[col - 1, currow])
        if curdir == 0:
            rwork.append(refseq[i - 1])
            qwork.append(qseq[currow - 1])
            currow -= 1
            col -= 1
            i -= 1
        else:
            for _ in range(curdir):
                rwork.append(refseq[i - 1])
                qwork.append("-")
                i -= 1
                col -= 1
    while currow > 0:
        rwork.append("-")
        qwork.append(qseq[currow - 1])
        currow -= 1
    return "".join(reversed(rwork)), "".join(reversed(qwork))
