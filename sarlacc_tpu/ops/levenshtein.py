"""Batched masked-Levenshtein distances on device.

Device replacement for both the all-pairs kernel (src/compute_lev_masked.cpp)
and the sorted trie's thresholded search (src/sorted_trie.cpp): instead of a
pruned trie walk, distances for *tiles of pairs* advance together through a
``lax.scan`` column DP, and thresholding happens afterwards.  Dense regular
compute suits an accelerator better than pointer-chasing, and the
doubled-integer cost model
(match 0, N-vs-anything 1, mismatch/indel 2 — sorted_trie.cpp:13-21) makes
thresholding exact in int32: ``dist2 <= 2*limit`` reproduces the trie's
neighbour sets bit-for-bit, and ``dist2 / 2`` reproduces the float masked
distance of compute_lev_masked.cpp (N contributes 0.5).

The column recurrence ``col[i] = min(prev[i]+2, col[i-1]+2, prev[i-1]+ms)``
carries a sequential dependence through ``col[i-1]``; as in :mod:`.align` it
unrolls to a shifted prefix-min — ``col[i] = min_k (cand[k] + 2*(i-k))`` with
``cand[i] = min(prev[i]+2, prev[i-1]+ms_i)`` — computed with ``lax.cummin``,
so the pair axis and the position axis stay fully parallel.
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lev2_pairs", "lev2_condensed", "lev2_matrix", "lev2_neighbor_pairs"]


def _pairs_scan(codes_a, lens_a, codes_b, lens_b):
    """Doubled masked Levenshtein for P pairs of padded code rows (traceable).

    codes_* : [P, L] int32 (A=0..N=4, pad=5); lens_* : [P] int32.
    Returns [P] int32 doubled distances.
    """
    P, L = codes_a.shape
    idx = jnp.arange(L + 1, dtype=jnp.int32)[None, :]  # [1, L+1]

    prev0 = jnp.broadcast_to(2 * idx, (P, L + 1))
    ans0 = 2 * lens_a.astype(jnp.int32)  # lb == 0 answer

    a_is_n = codes_a == 4  # [P, L]

    def step(carry, jx):
        prev, ans = carry
        b = jax.lax.dynamic_index_in_dim(codes_b, jx, 1, keepdims=True)  # [P,1]
        ms = jnp.where(
            jnp.logical_or(b == 4, a_is_n),
            1,
            jnp.where(codes_a == b, 0, 2),
        ).astype(jnp.int32)  # [P, L]
        cand = jnp.concatenate(
            [
                jnp.full((P, 1), 2 * (jx + 1), jnp.int32),
                jnp.minimum(prev[:, 1:] + 2, prev[:, :-1] + ms),
            ],
            axis=1,
        )
        t = cand - 2 * idx
        col = jax.lax.cummin(t, axis=1) + 2 * idx
        got = jnp.take_along_axis(col, lens_a[:, None].astype(jnp.int32), axis=1)[:, 0]
        ans = jnp.where(jx + 1 == lens_b, got, ans)
        return (col, ans), None

    (_, ans), _ = jax.lax.scan(
        step, (prev0, ans0), jnp.arange(L, dtype=jnp.int32)
    )
    return ans


lev2_pairs = jax.jit(_pairs_scan)


def _bucket(n: int) -> int:
    """Round P up to a power-of-two bucket (>= 256) to bound recompiles."""
    b = 256
    while b < n:
        b *= 2
    return b


def _tile_d2(codes, lengths, i0, j0, TI: int, TJ: int, L: int):
    """Doubled-distance DP for one [TI, TJ] tile; returns int32 [TI, TJ].

    ``codes`` [N, L] int32 and ``lengths`` [N] stay device-resident across
    tiles — the host ships the n-row table once instead of materializing
    O(n^2) per-pair operand rows (which made umi_group upload-bound).
    """
    i0 = jnp.asarray(i0, jnp.int32)
    j0 = jnp.asarray(j0, jnp.int32)
    z = jnp.int32(0)
    a = jax.lax.dynamic_slice(codes, (i0, z), (TI, L))  # [TI, L]
    la = jax.lax.dynamic_slice(lengths, (i0,), (TI,)).astype(jnp.int32)
    b = jax.lax.dynamic_slice(codes, (j0, z), (TJ, L))  # [TJ, L]
    lb = jax.lax.dynamic_slice(lengths, (j0,), (TJ,)).astype(jnp.int32)

    # Layout: the DP position axis (L+1, tiny — e.g. 11 for UMIs) sits on
    # sublanes and the TJ pair axis on lanes, so every vreg is full.  The
    # transposed layout ([TI, TJ, L+1], L+1 minor) wasted 7/8ths of each
    # lane group for short sequences.
    idx = jnp.arange(L + 1, dtype=jnp.int32)[None, :, None]  # [1, L+1, 1]
    prev0 = jnp.broadcast_to(2 * idx, (TI, L + 1, TJ))
    ans0 = jnp.broadcast_to(2 * la[:, None], (TI, TJ))  # lb == 0 answer
    a_is_n = (a == 4)[:, :, None]  # [TI, L, 1]
    a_b = a[:, :, None]  # [TI, L, 1]
    la_idx = jnp.broadcast_to(la[:, None, None], (TI, 1, TJ))

    def step(carry, jx):
        prev, ans = carry
        bj = jax.lax.dynamic_index_in_dim(b, jx, 1, keepdims=True)  # [TJ, 1]
        bj = bj.T[None, :, :]  # [1, 1, TJ]
        ms = jnp.where(
            jnp.logical_or(bj == 4, a_is_n),
            1,
            jnp.where(a_b == bj, 0, 2),
        ).astype(jnp.int32)  # [TI, L, TJ]
        cand = jnp.concatenate(
            [
                jnp.full((TI, 1, TJ), 2 * (jx + 1), jnp.int32),
                jnp.minimum(prev[:, 1:] + 2, prev[:, :-1] + ms),
            ],
            axis=1,
        )
        t = cand - 2 * idx
        col = jax.lax.cummin(t, axis=1) + 2 * idx
        got = jnp.take_along_axis(col, la_idx, axis=1)[:, 0]
        ans = jnp.where(jx + 1 == lb[None, :], got, ans)
        return (col, ans), None

    (_, ans), _ = jax.lax.scan(
        step, (prev0, ans0), jnp.arange(L, dtype=jnp.int32)
    )
    return ans


@functools.partial(jax.jit, static_argnames=("TI", "TJ", "L", "wide"))
def _lev2_tile_kernel(codes, lengths, i0, j0, TI: int, TJ: int, L: int, wide: bool = False):
    """One dense [TI, TJ] tile of the all-pairs matrix.

    The readback is int16 (halves the transfer) unless ``wide`` — doubled
    distances can reach 2*max(la, lb), so sequences longer than 16383 bases
    must read back int32 to avoid silent wraparound.
    """
    ans = _tile_d2(codes, lengths, i0, j0, TI, TJ, L)
    return ans if wide else ans.astype(jnp.int16)


def _lev2_matrix_tiled(codes: np.ndarray, lengths: np.ndarray, tile: int = 512) -> np.ndarray:
    """Full doubled-distance matrix via device-resident tiles.

    Tiles dispatch before any readback (async), so device compute of later
    tiles overlaps the readback of earlier ones.
    """
    n = codes.shape[0]
    Lb = 8
    while Lb < codes.shape[1]:
        Lb *= 2
    T = min(tile, _bucket(n))
    n_pad = ((n + T - 1) // T) * T
    cp = np.full((n_pad, Lb), 5, np.int32)
    cp[:n, : codes.shape[1]] = codes
    lp = np.zeros(n_pad, np.int32)
    lp[:n] = lengths
    codes_dev = jnp.asarray(cp)
    lens_dev = jnp.asarray(lp)
    wide = int(lengths.max(initial=0)) > 16383  # int16 would wrap (d2 <= 2L)

    # Bounded in-flight window: tiles dispatch ahead of readbacks (async) but
    # never hold more than ~max_inflight [T, T] results on device at once, so
    # arbitrarily large n cannot OOM the chip.
    max_inflight = max(1, (64 << 20) // (T * T * (4 if wide else 2)))
    tiles = [
        (i0, j0)
        for i0 in range(0, n_pad, T)
        for j0 in range(i0, n_pad, T)
    ]
    mat = np.zeros((n, n), dtype=np.int32)

    def _collect(i0, j0, dev):
        blk = np.asarray(dev, dtype=np.int32)
        ih = min(i0 + T, n) - i0
        jh = min(j0 + T, n) - j0
        if ih <= 0 or jh <= 0:
            return
        mat[i0 : i0 + ih, j0 : j0 + jh] = blk[:ih, :jh]
        if j0 != i0:
            mat[j0 : j0 + jh, i0 : i0 + ih] = blk[:ih, :jh].T

    inflight: list = []
    for i0, j0 in tiles:
        dev = _lev2_tile_kernel(
            codes_dev, lens_dev, i0, j0, TI=T, TJ=T, L=Lb, wide=wide
        )
        inflight.append((i0, j0, dev))
        if len(inflight) >= max_inflight:
            _collect(*inflight.pop(0))
    for item in inflight:
        _collect(*item)
    return mat


def _run_pairs(ca, la, cb, lb) -> np.ndarray:
    P = ca.shape[0]
    if P == 0:
        return np.zeros(0, dtype=np.int32)
    B = _bucket(P)
    if B != P:
        pad = B - P
        ca = np.concatenate([ca, np.full((pad, ca.shape[1]), 5, ca.dtype)])
        cb = np.concatenate([cb, np.full((pad, cb.shape[1]), 5, cb.dtype)])
        la = np.concatenate([la, np.zeros(pad, la.dtype)])
        lb = np.concatenate([lb, np.zeros(pad, lb.dtype)])
    out = np.asarray(
        lev2_pairs(
            jnp.asarray(ca, jnp.int32),
            jnp.asarray(la, jnp.int32),
            jnp.asarray(cb, jnp.int32),
            jnp.asarray(lb, jnp.int32),
        )
    )
    return out[:P]


def lev2_condensed(codes: np.ndarray, lengths: np.ndarray, max_pairs: int = 1 << 22) -> np.ndarray:
    """All-pairs doubled distances, condensed lower-triangle (i<j, i-major).

    Matches compute_lev_masked.cpp's emission order (:44-55); divide by 2.0
    for the float masked distance.
    """
    n = codes.shape[0]
    if 2 <= n <= 8192:
        # Moderate n: tiles beat per-pair operand materialization.
        mat = _lev2_matrix_tiled(codes.astype(np.int32), lengths)
        iu, ju = np.triu_indices(n, k=1)
        return mat[iu, ju].astype(np.int32)
    iu, ju = np.triu_indices(n, k=1)
    out = np.zeros(iu.size, dtype=np.int32)
    for at in range(0, iu.size, max_pairs):
        sl = slice(at, min(at + max_pairs, iu.size))
        out[sl] = _run_pairs(
            codes[iu[sl]], lengths[iu[sl]], codes[ju[sl]], lengths[ju[sl]]
        )
    return out


@functools.partial(jax.jit, static_argnames=("TI", "TJ", "NJT", "L", "KCAP"))
def _lev2_rowblock_sparse(
    codes, lengths, n, i0, jt0, njt, thr,
    TI: int, TJ: int, NJT: int, L: int, KCAP: int,
):
    """Thresholded neighbours of one row block, never materializing the tile
    matrix on the host (the trie replacement at scale —
    src/sorted_trie.cpp:107-187's result, dense-regular compute).

    Scans ``NJT`` column tiles starting at ``jt0`` (only ``njt`` are real);
    per query row, matched column indices (``d2 <= thr``, upper triangle
    ``j >= i`` only, diagonal included) append in ascending-j order to a
    [TI, KCAP] buffer via a lane-wise compaction sort — no device scatter.

    Returns (nbrj [TI, KCAP] int32, counts [TI] int32).  ``counts`` may
    exceed KCAP: overflow rows lost entries and the caller must retry with a
    bigger KCAP (power-of-two bucketed, so recompiles stay bounded).
    """
    i0 = jnp.asarray(i0, jnp.int32)
    jt0 = jnp.asarray(jt0, jnp.int32)
    n = jnp.asarray(n, jnp.int32)
    njt = jnp.asarray(njt, jnp.int32)
    thr = jnp.asarray(thr, jnp.int32)
    ig = i0 + jnp.arange(TI, dtype=jnp.int32)[:, None]  # [TI, 1]
    DEADJ = jnp.int32(0x3FFFFFFF)

    def step(carry, t):
        buf, cnt = carry  # buf [TI, KCAP] ascending-j (DEADJ pad), cnt [TI]
        jt = jt0 + t * TJ
        d2 = _tile_d2(codes, lengths, i0, jt, TI, TJ, L)
        jg = jt + jnp.arange(TJ, dtype=jnp.int32)[None, :]  # [1, TJ]
        ok = (
            (d2 <= thr)
            & (jg >= ig)
            & (jg < n)
            & (ig < n)
            & (t < njt)
        )
        hits = jnp.where(ok, jg, DEADJ).astype(jnp.int32)  # already ascending
        cat = jnp.concatenate([buf, hits], axis=1)  # [TI, KCAP + TJ]
        # Lane-wise compaction: entries keep relative order (keys are their
        # original lanes, unique), dead entries (DEADJ) sink right because
        # both halves individually have dead entries rightmost... not true of
        # `hits`, so key dead lanes to the far right explicitly.
        lanes = jnp.arange(KCAP + TJ, dtype=jnp.int32)[None, :]
        key = jnp.where(cat == DEADJ, lanes + (KCAP + TJ), lanes)
        key = jnp.broadcast_to(key, cat.shape)
        _, packed = jax.lax.sort((key, cat), dimension=1, num_keys=1)
        return (packed[:, :KCAP], cnt + ok.sum(axis=1).astype(jnp.int32)), None

    buf0 = jnp.full((TI, KCAP), DEADJ, jnp.int32)
    cnt0 = jnp.zeros(TI, jnp.int32)
    (buf, cnt), _ = jax.lax.scan(
        step, (buf0, cnt0), jnp.arange(NJT, dtype=jnp.int32)
    )
    return buf, cnt


@functools.partial(jax.jit, static_argnames=("P", "L"))
def _lev2_pairs_indexed(codes, lengths, ia, ib, thr, P: int, L: int):
    """d2 <= thr verdicts for P candidate pairs, gathered ON DEVICE from the
    resident [n, L] code table and returned as little-endian packed bits
    ([P/8] uint8) — one bit per pair reads back 32x fewer bytes than
    int32, which matters for the millions of candidates at 1M-UMI scale.
    """
    ca = jnp.take(codes, ia, axis=0)
    la = jnp.take(lengths, ia)
    cb = jnp.take(codes, ib, axis=0)
    lb = jnp.take(lengths, ib)
    d2 = _pairs_scan(ca, la, cb, lb)
    ok = (d2 <= thr).reshape(P // 8, 8).astype(jnp.uint8)
    weights = (2 ** jnp.arange(8, dtype=jnp.uint8))[None, :]
    return (ok * weights).sum(axis=1).astype(jnp.uint8)


def _verify_pairs_device(
    codes: np.ndarray, lengths: np.ndarray, ua: np.ndarray, ub: np.ndarray,
    thr: int, chunk: int = 1 << 19,
) -> np.ndarray:
    """Boolean verdicts (d2 <= thr) for candidate pairs (ua, ub).

    The code table ships once; per chunk only two int32 index vectors go up
    and a packed bitmask comes back.  Chunks dispatch ahead of readbacks.
    """
    P = ua.size
    if P == 0:
        return np.zeros(0, bool)
    Lb = 8
    while Lb < codes.shape[1]:
        Lb *= 2
    n = codes.shape[0]
    cp = np.full((n + 1, Lb), 5, np.int32)  # +1: a safe pad row for bucket slack
    cp[:n, : codes.shape[1]] = codes
    lp = np.zeros(n + 1, np.int32)
    lp[:n] = lengths
    codes_dev = jnp.asarray(cp)
    lens_dev = jnp.asarray(lp)
    thr_dev = jnp.asarray(int(thr), jnp.int32)

    out = np.zeros(P, bool)
    inflight: list = []

    def _collect(sl, dev):
        bits = np.unpackbits(np.asarray(dev), bitorder="little")
        out[sl] = bits[: sl.stop - sl.start].astype(bool)

    for at in range(0, P, chunk):
        sl = slice(at, min(at + chunk, P))
        p = sl.stop - sl.start
        B = _bucket(max(p, 8))
        ia = np.full(B, n, np.int32)
        ib = np.full(B, n, np.int32)
        ia[:p] = ua[sl]
        ib[:p] = ub[sl]
        dev = _lev2_pairs_indexed(
            codes_dev, lens_dev, jnp.asarray(ia), jnp.asarray(ib), thr_dev,
            P=B, L=Lb,
        )
        inflight.append((sl, dev))
        if len(inflight) >= 8:
            _collect(*inflight.pop(0))
    for item in inflight:
        _collect(*item)
    return out


#: Max packed variant length for the symmetric-delete filter: base-5 digits
#: plus a leading sentinel must fit uint64 (5^25 * 2 < 2^64).
_FILTER_MAX_LEN = 24
#: Max deletion variants per string before the filter costs more than it saves.
_FILTER_MAX_VARIANTS = 512


def _unique_rows(codes: np.ndarray):
    """np.unique(codes, axis=0) with all four returns, but ~20x faster for
    short code rows: rows pack into one big-endian base-6 uint64 key (codes
    are 0..5 incl. pad), preserving np.unique's row-lexicographic order, so
    the sort runs on scalars instead of void views."""
    n, W = codes.shape
    if n == 0 or W > 24 or (W and (codes.min() < 0 or codes.max() > 5)):
        return np.unique(
            codes, axis=0, return_index=True, return_inverse=True,
            return_counts=True,
        )
    w6 = np.power(np.uint64(6), np.arange(W - 1, -1, -1, dtype=np.uint64))
    keys = codes.astype(np.uint64) @ w6
    _, first_idx, inv, cnt = np.unique(
        keys, return_index=True, return_inverse=True, return_counts=True
    )
    return codes[first_idx], first_idx, inv, cnt


def _delete_variant_entries(
    codes: np.ndarray, lengths: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """(hash, owner) entries for every <=k-deletion variant of every string.

    Variants pack base-5 with a leading sentinel digit (so different lengths
    never collide).  Strings are processed per length class; combination
    enumeration is host Python but each combination's packing is one
    vectorized multiply-add over all strings of that length.
    """
    pow5 = np.power(np.uint64(5), np.arange(_FILTER_MAX_LEN + 1, dtype=np.uint64))
    hashes: list[np.ndarray] = []
    owners: list[np.ndarray] = []
    for L in np.unique(lengths):
        Li = int(L)
        rows = np.flatnonzero(lengths == L)
        sub = codes[rows, :Li].astype(np.uint64)
        for d in range(min(int(k), Li) + 1):
            m = Li - d
            sentinel = pow5[m]
            w = pow5[:m]
            for del_pos in itertools.combinations(range(Li), d):
                keep = np.setdiff1d(
                    np.arange(Li), np.asarray(del_pos, np.int64),
                    assume_unique=True,
                )
                h = sub[:, keep] @ w + sentinel if m else np.full(
                    rows.size, sentinel, np.uint64
                )
                hashes.append(h)
                owners.append(rows)
    if not hashes:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.concatenate(hashes), np.concatenate(owners).astype(np.int64)


def _candidate_pairs_from_entries(
    h: np.ndarray, owner: np.ndarray, pair_cap: int
) -> np.ndarray | None:
    """Unordered candidate pairs [m, 2] (lo, hi) from shared-variant runs;
    None if the run structure blows past ``pair_cap`` (low-complexity
    pathologies).  The C++ path (native.candidate_pairs_native) does the
    sort/run-walk/dedup in one pass; this numpy body is the fallback and
    parity oracle."""
    from ..native import candidate_pairs_native, native_available

    if native_available():
        keys = candidate_pairs_native(
            h, owner, cap_hint=min(max(8 * h.size, 1 << 20), pair_cap),
            pair_cap=pair_cap,
        )
        if keys is None:  # raw pair count blew past pair_cap
            return None
        out = np.empty((keys.size, 2), np.int64)
        out[:, 0] = (keys >> np.uint64(32)).astype(np.int64)
        out[:, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
        return out

    order = np.argsort(h, kind="stable")
    hs = h[order]
    ids = owner[order]
    new = np.empty(hs.size, bool)
    new[:1] = True
    np.not_equal(hs[1:], hs[:-1], out=new[1:])
    run_start = np.flatnonzero(new)
    run_len = np.diff(np.append(run_start, hs.size))
    run_id = np.cumsum(new) - 1
    pos = np.arange(hs.size) - run_start[run_id]
    cnt = (run_len[run_id] - pos - 1).astype(np.int64)
    tot = int(cnt.sum())
    if tot > pair_cap:
        return None
    first = np.repeat(np.arange(hs.size), cnt)
    offs = np.repeat(np.cumsum(cnt) - cnt, cnt)
    second = first + 1 + (np.arange(tot, dtype=np.int64) - offs)
    pa = ids[first]
    pb = ids[second]
    keep = pa != pb  # same string can emit one variant twice
    pa, pb = pa[keep], pb[keep]
    lo = np.minimum(pa, pb)
    hi = np.maximum(pa, pb)
    # Dedup on (lo, hi): close pairs share many variants.
    key = (lo.astype(np.uint64) << np.uint64(32)) | hi.astype(np.uint64)
    uk = np.unique(key)
    out = np.empty((uk.size, 2), np.int64)
    out[:, 0] = (uk >> np.uint64(32)).astype(np.int64)
    out[:, 1] = (uk & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return out


def _neighbor_pairs_filtered(
    codes: np.ndarray, lengths: np.ndarray, limit: int, thr: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact neighbour pairs in unique-string space via symmetric-delete
    candidate generation + device DP verification; None when the filter
    heuristics do not hold and the caller must use the row-block scan.

    Exactness: for N-free pairs every edit costs exactly 2 doubled units, so
    ``d2 <= 2*limit  <=>  lev <= limit``; if ``lev(a, b) = e`` then an
    optimal alignment's matched-equal columns form a common subsequence
    reachable with ``del+sub <= e`` deletions from ``a`` and
    ``ins+sub <= e`` from ``b`` — so any pair within ``limit`` shares a
    ``<=limit``-deletion variant (the reference trie's pruned walk,
    sorted_trie.cpp:107-187, is replaced by hashing; results are identical
    because every candidate is verified by the exact DP).  Strings containing
    N (where N-vs-anything costs 1, sorted_trie.cpp:13-21) skip the filter
    and are verified against *all* strings.
    """
    n = codes.shape[0]
    Lmax = int(lengths.max(initial=0))
    if Lmax > _FILTER_MAX_LEN:
        return None
    k = int(limit)
    nvar = sum(
        int(np.prod(np.arange(Lmax - d + 1, Lmax + 1)) // np.prod(np.arange(1, d + 1)))
        if d else 1
        for d in range(min(k, Lmax) + 1)
    )
    if nvar > _FILTER_MAX_VARIANTS:
        return None

    pos = np.arange(codes.shape[1])[None, :]
    has_n = ((codes == 4) & (pos < lengths[:, None])).any(axis=1)
    n_rows = np.flatnonzero(has_n)
    a_rows = np.flatnonzero(~has_n)
    # N-containing strings pair against everything: bail out if that cross
    # product alone rivals the dense scan.
    if n_rows.size * n > max(1 << 26, n):
        return None

    # Budget on raw (pre-dedup) candidate volume: beyond it the filter is
    # no better than the dense scan (pathological low-complexity inputs)
    # and the caller falls back to the row-block path.
    pair_cap = min(max(1 << 24, n * 2048), 1 << 28)

    from ..native import (
        ABORTED,
        sym_delete_verify_native,
        verify_pairs_native,
    )

    # Fast path: the whole search — variant hashing, bucketed sort,
    # shared-variant run walk, memoized banded verification — fused in one
    # multithreaded C++ pass; the heavily-duplicated raw pair stream is
    # never materialized and each pair's DP runs once per thread.  The
    # banded DP is exact for the d2 <= 2*limit decision because any DP cell
    # (i, j) costs >= 2|i-j|, so no accepting path leaves the band.
    fused = sym_delete_verify_native(
        codes[a_rows], lengths[a_rows], k, int(limit), thr, raw_cap=1 << 31
    )
    if fused is ABORTED:
        return None
    if fused is not None:
        sa = a_rows[(fused >> np.uint64(32)).astype(np.int64)]
        sb = a_rows[(fused & np.uint64(0xFFFFFFFF)).astype(np.int64)]
    else:
        h, owner = _delete_variant_entries(codes[a_rows], lengths[a_rows], k)
        owner = a_rows[owner]
        cand = _candidate_pairs_from_entries(h, owner, pair_cap)
        if cand is None:
            return None
        ok = _verify_pairs_device(codes, lengths, cand[:, 0], cand[:, 1], thr)
        sa, sb = cand[ok, 0], cand[ok, 1]

    parts_a = [sa]
    parts_b = [sb]
    if n_rows.size:
        # N rows vs every row (self included — the diagonal is not free for
        # them), upper-triangle normalized, deduped against double-counting
        # N-vs-N pairs.
        ra = np.repeat(n_rows, n)
        rb = np.tile(np.arange(n, dtype=np.int64), n_rows.size)
        lo = np.minimum(ra, rb)
        hi = np.maximum(ra, rb)
        key = (lo.astype(np.uint64) << np.uint64(32)) | hi.astype(np.uint64)
        uk = np.unique(key)
        na = (uk >> np.uint64(32)).astype(np.int64)
        nb = (uk & np.uint64(0xFFFFFFFF)).astype(np.int64)
        ok = verify_pairs_native(codes, lengths, na, nb, int(limit), thr)
        if ok is None:
            ok = _verify_pairs_device(codes, lengths, na, nb, thr)
        parts_a.append(na[ok])
        parts_b.append(nb[ok])
    ua = np.concatenate(parts_a)
    ub = np.concatenate(parts_b)
    # Diagonal for N-free strings is always distance 0.
    ua = np.concatenate([ua, a_rows])
    ub = np.concatenate([ub, a_rows])
    return ua.astype(np.int64), ub.astype(np.int64)


def _neighbor_pairs_rowblock(
    codes: np.ndarray, lengths: np.ndarray, thr: int, limit: int,
    tile: int, kcap: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense row-block scan fallback (unique-string space): tiles stream
    through the device kernel which emits only surviving column indices."""
    n = codes.shape[0]
    lengths = np.asarray(lengths, np.int32)
    perm = np.argsort(lengths, kind="stable").astype(np.int64)
    s_len = lengths[perm]

    Lb = 8
    while Lb < codes.shape[1]:
        Lb *= 2
    TI = TJ = min(tile, _bucket(n) if n > 256 else 256)
    n_pad = ((n + TI - 1) // TI) * TI
    cp = np.full((n_pad, Lb), 5, np.int32)
    cp[:n, : codes.shape[1]] = codes[perm]
    lp = np.zeros(n_pad, np.int32)
    lp[:n] = s_len
    codes_dev = jnp.asarray(cp)
    lens_dev = jnp.asarray(lp)

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    # Per row block: column range from the exact length prune, upper
    # triangle only.  Work splits into fixed-size column-tile CHUNKS so a
    # BOUNDED set of compiled programs serves every launch (per-block
    # power-of-two scan lengths compiled a fresh program per distinct
    # bucket), and chunk launches dispatch asynchronously in a bounded
    # window.  Two size classes: small inputs take the NJT=4 program instead of
    # paying up to 31 masked-but-computed dead tiles in the NJT=32 one.
    NJT_BIG, NJT_SMALL = 32, 4
    chunks: list[tuple[int, int, int]] = []
    for i0 in range(0, n_pad, TI):
        if i0 >= n:
            continue
        hi_len = int(s_len[min(i0 + TI, n) - 1])
        j_hi = int(np.searchsorted(s_len, hi_len + int(limit), side="right"))
        jt0 = i0  # j >= i
        njt = max(0, -(-(min(max(j_hi, i0 + 1), n) - jt0) // TJ))
        c0 = 0
        while c0 < njt:
            step = NJT_BIG if njt - c0 > NJT_SMALL else NJT_SMALL
            chunks.append((i0, jt0 + c0 * TJ, min(step, njt - c0)))
            c0 += step

    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    todo = [(i0, jt0, njt, kcap) for (i0, jt0, njt) in chunks]
    # Bounded in-flight window: enough launches to hide dispatch latency
    # without holding hundreds of [TI, KCAP] buffers on device.
    MAX_INFLIGHT = 64

    def _collect(item, retry):
        i0, jt0, njt, kc, (buf_dev, cnt_dev) = item
        cnt = np.asarray(cnt_dev)
        if (cnt > _bkt(kc, 64)).any():
            retry.append((i0, jt0, njt, int(cnt.max())))
            return
        buf = np.asarray(buf_dev)
        lanes = np.arange(buf.shape[1], dtype=np.int32)[None, :]
        mask = lanes < cnt[:, None]
        out_i.append(np.repeat(i0 + np.arange(buf.shape[0], dtype=np.int32), cnt))
        out_j.append(buf[mask])

    while todo:
        retry: list = []
        inflight: list = []
        for i0, jt0, njt, kc in todo:
            dev = _lev2_rowblock_sparse(
                codes_dev, lens_dev, n, i0, jt0, njt, thr,
                TI=TI, TJ=TJ, NJT=NJT_BIG if njt > NJT_SMALL else NJT_SMALL,
                L=Lb, KCAP=_bkt(kc, 64),
            )
            inflight.append((i0, jt0, njt, kc, dev))
            if len(inflight) >= MAX_INFLIGHT:
                _collect(inflight.pop(0), retry)
        for item in inflight:
            _collect(item, retry)
        todo = retry
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    si = np.concatenate(out_i).astype(np.int64)
    sj = np.concatenate(out_j).astype(np.int64)
    return perm[si], perm[sj]


def lev2_neighbor_pairs(
    codes: np.ndarray, lengths: np.ndarray, limit: int,
    tile: int = 512, kcap: int = 64, assume_unique: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Sparse thresholded neighbours: all (i, j), i <= j, with doubled
    distance <= 2*limit — including the diagonal, which is NOT free when a
    sequence contains N (sorted_trie.cpp:13-21).

    The O(n^2) distance matrix never exists anywhere.  Identical rows share
    one DP (``assume_unique=True`` skips that dedup when the caller already
    collapsed duplicates).  Unique strings then go through one of two exact
    engines:

    * **symmetric-delete filter** (short strings, small limits — the UMI
      regime): <=limit-deletion variant hashing proposes candidate pairs, a
      batched device DP verifies them, N-containing strings verify against
      everything (:func:`_neighbor_pairs_filtered`);
    * **row-block scan** (everything else): tiles stream through the device
      kernel which emits surviving column indices, with an exact
      length-sort prune (:func:`_neighbor_pairs_rowblock`).

    Returns (qi, qj) int32 arrays in original index space.
    """
    n_reads = codes.shape[0]
    if n_reads == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lengths = np.asarray(lengths, np.int32)
    if assume_unique:
        n = n_reads
        ucnt = np.ones(n, np.int64)
        mem_order = np.arange(n, dtype=np.int64)
        mem_start = np.arange(n, dtype=np.int64)
    else:
        # Exact dedup: distance depends only on string contents (the
        # reference trie's identical-consecutive-query short-circuit,
        # sorted_trie.cpp:253-257, batched).
        uniq, _, uid, _ = _unique_rows(codes)
        uid = uid.ravel().astype(np.int64)
        n = uniq.shape[0]
        ucnt = np.bincount(uid, minlength=n).astype(np.int64)
        mem_order = np.argsort(uid, kind="stable").astype(np.int64)
        mem_start = np.concatenate([[0], np.cumsum(ucnt)[:-1]])
        ulen = np.zeros(n, np.int32)
        ulen[uid] = lengths
        codes, lengths = uniq, ulen

    thr = 2 * int(limit)
    pairs = _neighbor_pairs_filtered(codes, lengths, int(limit), thr)
    if pairs is None:
        pairs = _neighbor_pairs_rowblock(
            codes, lengths, thr, int(limit), tile, kcap
        )
    ua, ub = pairs
    if ua.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if assume_unique:
        # Identity expansion: skip the cross-product machinery (it would be
        # 6 full-size gathers over pairs that all expand 1:1).
        return (
            np.minimum(ua, ub).astype(np.int32),
            np.maximum(ua, ub).astype(np.int32),
        )

    # Unique ids -> read space.  Each unique pair (a, b) expands to the
    # cross product of its member read sets; for a == b keep one
    # orientation per unordered read pair.
    ca = ucnt[ua]
    cb = ucnt[ub]
    sz = ca * cb
    starts = np.concatenate([[0], np.cumsum(sz)[:-1]])
    total = int(sz.sum())
    pid = np.repeat(np.arange(ua.size), sz)
    o = np.arange(total, dtype=np.int64) - starts[pid]
    x = mem_order[mem_start[ua][pid] + o // cb[pid]]
    y = mem_order[mem_start[ub][pid] + o % cb[pid]]
    keep = (ua[pid] != ub[pid]) | (x <= y)
    x, y = x[keep], y[keep]
    return (
        np.minimum(x, y).astype(np.int32),
        np.maximum(x, y).astype(np.int32),
    )


def lev2_matrix(codes: np.ndarray, lengths: np.ndarray, max_pairs: int = 1 << 22) -> np.ndarray:
    """Full symmetric doubled-distance matrix [n, n] int32.

    The diagonal is computed, not assumed zero: an ``N`` matches *nothing*,
    itself included (sorted_trie.cpp:13-21), so self-distances of
    N-containing sequences are positive — which is how the reference's
    neighbour sets can legitimately come up empty.
    """
    n = codes.shape[0]
    if n >= 2:
        # The tiled kernel computes the diagonal (i0 == j0 tiles include it),
        # so no special-casing is needed here.
        return _lev2_matrix_tiled(codes.astype(np.int32), lengths)
    mat = np.zeros((n, n), dtype=np.int32)
    if n == 1:
        mat[0, 0] = _run_pairs(codes, lengths, codes, lengths)[0]
    return mat
