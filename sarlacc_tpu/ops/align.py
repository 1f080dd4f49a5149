"""Batched quality-aware affine-gap alignment on device (JAX/XLA).

Batched re-design of the reference's central DP engine
(``src/reference_align.cpp`` in MarioniLab/sarlacc): instead of one read at a
time through a scalar C++ loop, thousands of padded reads advance through the
DP **together**, one reference column per step of a ``lax.scan``.  Within a
column every quantity is elementwise over the ``(batch, read-position)`` plane
except the vertical (read-axis) gap, whose first-order recurrence

    V[i] = max(S[i-1] - open_v, V[i-1] - ext_v)

unrolls to ``V[i] = max_{k<i} (max(M,H)[k] - open_v - (i-1-k) * ext_v)`` (the
``V[k-1]`` contributions are dominated because ``open_v >= ext_v``), i.e. a
shifted prefix-max computed with ``lax.cummax`` — no sequential dependence
along the read axis.  The scan therefore runs |reference| steps of pure
elementwise work, which XLA fuses into a few kernels per column.

Semantics mirror the reference exactly (cited as file:line into
/root/reference):

* scores: ``gap_open`` stored as open+extend (reference_align.cpp:8); fitting
  ("local") mode zeroes the first column and frees vertical gaps in the last
  column (reference_align.cpp:65-67, 88-90, 120-121).
* tie-breaks: diagonal wins only if strictly greater than both gaps; the
  horizontal gap beats the vertical gap only if strictly greater
  (reference_align.cpp:162-174).
* directions: run-length encoded ints — 0 diagonal, +k for k left-steps,
  -k for k up-steps (reference_align.cpp:162-174) — with the jump-point
  bookkeeping of reference_align.cpp:126-155 reproduced via post-hoc
  tie-aware prefix scans, so the same backtracker logic applies.
* IUPAC degeneracy and the quality-indexed match/mismatch tables follow
  reference_align.cpp:15-52,184-225 via ``core.scoring``.

The kernel is float32 by default; enable float64 (CPU tests) by passing
float64 tables.  Scores are compared tie-tolerantly in tests, exactly as the
reference's own tests do against Biostrings (test-adaptor-align.R:38-40).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dp_align", "prepare_reads", "prepare_reference", "AlignResult"]

NEG_INF_F32 = -3.0e38  # finite stand-in for -inf; safe under further subtraction


def _neg_inf(dtype):
    return jnp.asarray(NEG_INF_F32, dtype=dtype)


def prepare_reference(ref, tables, dtype=jnp.float32):
    """An IUPACReference -> device arrays (modes [R], matched [R,5])."""
    from ..core.encode import iupac_reference

    if isinstance(ref, str):
        ref = iupac_reference(ref)
    return (
        jnp.asarray(ref.modes, dtype=jnp.int32),
        jnp.asarray(ref.matched, dtype=jnp.bool_),
        jnp.asarray(tables.match, dtype=dtype),
        jnp.asarray(tables.mismatch, dtype=dtype),
    )


def prepare_reads(batch, tables):
    """SeqBatch -> (codes i32 [N,L], qidx i32 [N,L], lengths i32 [N]).

    Padded positions get quality index 0; they never reach live DP cells
    because row i only consumes read positions < i <= length.  Codes and
    quality indices travel as int8 (values <= 93), a quarter of the int32
    upload, and are upcast on device.
    """
    codes = jnp.asarray(batch.codes, dtype=jnp.int8)
    if batch.quals is not None:
        qidx = np.zeros(batch.codes.shape, dtype=np.int8)
        width = batch.codes.shape[1]
        if len(batch):
            pos = np.arange(width)[None, :]
            valid = pos < batch.lengths[:, None]
            q = np.where(valid, batch.quals, tables.offset)
            qidx = np.asarray(tables.qual_index(q), dtype=np.int8)
        qidx = jnp.asarray(qidx)
    else:
        # Maximum quality: last table entry (minimum error).
        qidx = jnp.full(batch.codes.shape, tables.navail - 1, dtype=jnp.int8)
    return codes, qidx, jnp.asarray(batch.lengths, dtype=jnp.int32)


class AlignResult:
    """Scores plus (optionally) the run-length direction tensor."""

    def __init__(self, scores, dirs=None):
        self.scores = scores  # [N] float
        self.dirs = dirs  # [R, N, L+1] int16 or None (columns 1..R)


@functools.partial(
    jax.jit, static_argnames=("local", "need_directions")
)
def dp_align(
    codes,  # [N, L] int32 base codes (A=0..N=4, pad=5)
    qidx,  # [N, L] int32 quality table indices
    lengths,  # [N] int32
    modes,  # [R] int32 degeneracy mode 1..4
    matched,  # [R, 5] bool
    match_tab,  # [4, Q] float
    mismatch_tab,  # [4, Q] float
    gap_open,  # scalar float: raw gapOpening (the kernel adds gapExtension)
    gap_ext,  # scalar float
    local: bool = True,
    need_directions: bool = False,
):
    """Batched fitting/global alignment of every read against one reference.

    Returns (scores [N], dirs [R, N, L+1] int16 or None).
    """
    codes = codes.astype(jnp.int32)
    qidx = qidx.astype(jnp.int32)
    dtype = match_tab.dtype
    N, L = codes.shape
    R = modes.shape[0]
    L1 = L + 1

    ge = jnp.asarray(gap_ext, dtype)
    go = jnp.asarray(gap_open, dtype) + ge  # reference_align.cpp:8

    # Per-(read, position) match/mismatch cost for each degeneracy mode:
    # costm[m, n, i] = match_tab[m, qidx[n, i]].
    costm = jnp.take(match_tab, qidx, axis=1)  # [4, N, L]
    costmm = jnp.take(mismatch_tab, qidx, axis=1)  # [4, N, L]

    idx_row = jnp.arange(L1, dtype=jnp.int32)[None, :]  # [1, L1]
    neg = _neg_inf(dtype)

    # Column 0 (reference_align.cpp:65-74).
    if local:
        S0 = jnp.zeros((N, L1), dtype)
    else:
        ramp = -go - ge * (idx_row.astype(dtype) - 1.0)
        S0 = jnp.where(idx_row == 0, jnp.zeros((), dtype), ramp) * jnp.ones((N, 1), dtype)
    H0 = jnp.full((N, L1), neg, dtype)
    was_left0 = jnp.zeros((N, L1), jnp.bool_)
    ljp0 = jnp.zeros((N, L1), jnp.int32)

    def column(carry, xs):
        S, H, was_left, ljp = carry
        mode, matched_row, col = xs  # col is 1-based
        last = jnp.logical_and(local, col == R)
        vgo = jnp.where(last, jnp.zeros((), dtype), go)
        vge = jnp.where(last, jnp.zeros((), dtype), ge)

        # Cost row for this reference position.  Whether each observed base
        # matches is a boolean lookup of its code (the pad code 5 never
        # matches; rows past `length` are dead anyway).
        cm = jax.lax.dynamic_index_in_dim(costm, mode - 1, 0, keepdims=False)
        cmm = jax.lax.dynamic_index_in_dim(costmm, mode - 1, 0, keepdims=False)
        sel = jnp.concatenate([matched_row, jnp.zeros(1, jnp.bool_)])[codes]
        cost = jnp.where(sel, cm, cmm)  # [N, L]

        # Diagonal candidate (reference_align.cpp:157-160).
        M = jnp.concatenate([jnp.full((N, 1), neg, dtype), S[:, :-1] + cost], axis=1)

        # Horizontal gap with jump bookkeeping (reference_align.cpp:126-140).
        cand1_h = S - jnp.where(was_left, ge, go)
        jump_h = H - ge  # H carries the previous column's H values (== ljs)
        cond_h = cand1_h >= jump_h  # jump wins only if strictly greater
        Hn = jnp.where(cond_h, cand1_h, jump_h)

        # Vertical gap via shifted prefix-max (reference_align.cpp:142-155).
        mh = jnp.maximum(M, Hn)
        B = (mh - vgo) + idx_row.astype(dtype) * vge
        cum = jax.lax.cummax(B, axis=1)
        V = jnp.concatenate([jnp.full((N, 1), neg, dtype), cum[:, :-1]], axis=1) - (
            (idx_row.astype(dtype) - 1.0) * vge
        )
        V = jnp.where(idx_row == 0, neg, V)

        Sn = jnp.maximum(mh, V)

        # Choice + tie-breaks (reference_align.cpp:162-174).
        is_diag = jnp.logical_and(M > Hn, M > V)
        is_left = jnp.logical_and(jnp.logical_not(is_diag), Hn > V)

        if need_directions:
            # Left run lengths (reference_align.cpp:133-139): pos = col-1.
            pos = col - 1
            left_step = jnp.where(cond_h, 1, 1 + pos - ljp)
            ljpn = jnp.where(cond_h, pos, ljp)

            # Up run lengths (reference_align.cpp:145-154), reconstructed
            # post-hoc: cand1_v[i] = S[i-1] - (vge if dir[i-1]==up else vgo),
            # jump candidate = V[i-1] - vge, jump wins only if strictly
            # greater; the jump point is the last row where it did not.
            is_up_prev = jnp.concatenate(
                [
                    jnp.zeros((N, 1), jnp.bool_),
                    jnp.logical_not(jnp.logical_or(is_diag, is_left))[:, :-1],
                ],
                axis=1,
            )
            # cand1_v uses the *current* column's S at i-1.
            cand1_v = jnp.concatenate(
                [jnp.full((N, 1), neg, dtype), Sn[:, :-1]], axis=1
            ) - jnp.where(is_up_prev, vge, vgo)
            jump_v = jnp.concatenate(
                [jnp.full((N, 1), neg, dtype), V[:, :-1]], axis=1
            ) - vge
            cond_v = cand1_v >= jump_v
            pnt = jax.lax.cummax(jnp.where(cond_v, idx_row, 0), axis=1)
            pnt_prev = jnp.concatenate(
                [jnp.zeros((N, 1), jnp.int32), pnt[:, :-1]], axis=1
            )
            up_step = jnp.where(cond_v, 1, 1 + idx_row - pnt_prev)

            dir_enc = jnp.where(
                is_diag,
                0,
                jnp.where(is_left, left_step, -up_step),
            ).astype(jnp.int16)
            # Row 0 is always a single left step (reference_align.cpp:122-123).
            dir_enc = jnp.where(idx_row == 0, jnp.int16(1), dir_enc)
            out = dir_enc
        else:
            ljpn = ljp
            out = jnp.zeros((N, 0), jnp.int16)

        was_left_n = jnp.where(idx_row == 0, True, is_left)
        return (Sn, Hn, was_left_n, ljpn), out

    xs = (modes, matched, jnp.arange(1, R + 1, dtype=jnp.int32))
    (S_final, _, _, _), dirs = jax.lax.scan(
        column, (S0, H0, was_left0, ljp0), xs
    )

    scores = jnp.take_along_axis(S_final, lengths[:, None].astype(jnp.int32), axis=1)[:, 0]
    return scores, (dirs if need_directions else None)
