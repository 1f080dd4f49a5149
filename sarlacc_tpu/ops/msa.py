"""Device kernels for the multiple-sequence-alignment subsystem.

The reference delegates MSA to SeqAn's banded T-Coffee
(src/quick_msa.cpp:25-75): banded pairwise global alignments build a
consistency library, a guide tree orders progressive profile merges.  This
design keeps that algorithmic shape but batches the two DP workloads onto
device:

* :func:`banded_pair_align` — tiles of read-vs-read banded global affine
  alignments (the library construction workload).  Band coordinates
  ``j = i + lo + k`` turn the band into a dense ``[rows, W]`` plane; the
  within-row horizontal-gap recurrence unrolls to a ``cummax`` prefix scan
  exactly as in :mod:`.align`, so pairs × band stay fully parallel.
  SeqAn charges ``gap_open`` for the first gap character and ``gap_ext``
  for each subsequent one; we reproduce that convention.  NOTE: unlike
  SeqAn's fixed ``(-bw, +bw)`` band we widen the band by the length
  difference so a global path always exists — strictly more robust for
  ragged long reads.

* :func:`banded_profile_merge` — progressive profile-profile DP with
  library-sum column scores and zero gap cost (T-Coffee maximal weighted
  trace), batched over merges.

Backtrack information is standard Gotoh: 2-bit state choice plus gap-extend
bits, walked on device (:func:`_pair_walk_kernel`) so only matched position
pairs transfer to the host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["banded_pair_align", "banded_profile_merge", "banded_profile_merge_many", "band_halfwidth"]

NEG = -1.0e9  # integer-ish scores stay far from this


def band_halfwidth(la: int, lb: int, bandwidth: int) -> tuple[int, int]:
    """(lo, hi) diagonal offsets guaranteeing corner-to-corner feasibility."""
    diff = lb - la
    return (min(0, diff) - bandwidth, max(0, diff) + bandwidth)


@functools.partial(jax.jit, static_argnames=("rows", "width"))
def _banded_pair_kernel(
    codes_a,  # [P, LA] int32 (pad 5)
    codes_b,  # [P, LB] int32
    lens_a,  # [P]
    lens_b,  # [P]
    lo,  # [P] int32 per-pair band lower diagonal
    kmax,  # [P] int32 per-pair inclusive band plane limit (hi - lo)
    match,
    mismatch,
    gap_open,
    gap_ext,
    rows: int,
    width: int,
):
    """Returns (scores [P], dirs [rows, P, W] int8).

    dirs bits: 0-1 = choice at S (0 diag, 1 horiz/gap-in-A, 2 vert/gap-in-B),
    bit2 = horizontal gap extends, bit3 = vertical gap extends.
    Row i of dirs corresponds to DP row i+1 (sequence-A position i+1).
    """
    P = codes_a.shape[0]
    W = width
    karr = jnp.arange(W, dtype=jnp.int32)[None, :]  # [1, W]

    in_band = karr <= kmax[:, None]  # shape-padding must not widen the band
    j0 = lo[:, None] + karr  # j index at row 0
    # Row 0: S[0][j] = 0 if j == 0 else -(go + (j-1)*ge) for 1 <= j <= lb.
    jj = j0.astype(jnp.float32)
    s0 = jnp.where(
        j0 == 0,
        0.0,
        jnp.where(
            jnp.logical_and(jnp.logical_and(j0 >= 1, j0 <= lens_b[:, None]), in_band),
            -(gap_open + (jj - 1.0) * gap_ext),
            NEG,
        ),
    )
    h0 = jnp.where(s0 > NEG / 2, jnp.where(j0 >= 1, s0, NEG), NEG)
    v0 = jnp.full((P, W), NEG)

    def row(carry, i):
        S, H, V = carry  # previous row, band coords
        # j index for this row: j = i + lo + k.
        j = i + lo[:, None] + karr  # [P, W]
        valid = jnp.logical_and(jnp.logical_and(j >= 0, j <= lens_b[:, None]), in_band)
        alive = i <= lens_a[:, None]

        a_i = jnp.take_along_axis(
            codes_a, jnp.minimum(i - 1, codes_a.shape[1] - 1)[None].repeat(P, 0)[:, None], axis=1
        )  # [P,1]
        # b at j: gather per (P, W).
        jb = jnp.clip(j - 1, 0, codes_b.shape[1] - 1)
        b_j = jnp.take_along_axis(codes_b, jb, axis=1)  # [P, W]
        sub = jnp.where(a_i == b_j, match, mismatch)
        sub = jnp.where(
            jnp.logical_and(j >= 1, j <= lens_b[:, None]), sub, NEG
        )

        # Diagonal: (i-1, j-1) is the same k in the previous row.
        M = S + sub

        # Vertical (gap in B, consume A): (i-1, j) is k+1 in the previous row.
        S_up = jnp.concatenate([S[:, 1:], jnp.full((P, 1), NEG)], axis=1)
        V_up = jnp.concatenate([V[:, 1:], jnp.full((P, 1), NEG)], axis=1)
        Vn = jnp.maximum(S_up - gap_open, V_up - gap_ext)
        v_ext = V_up - gap_ext >= S_up - gap_open  # tie -> extend

        # Horizontal (gap in A, consume B): within-row prefix structure.
        mv = jnp.maximum(M, Vn)
        B = (mv - gap_open) + karr.astype(jnp.float32) * gap_ext
        cum = jax.lax.cummax(B, axis=1)
        Hn = jnp.concatenate([jnp.full((P, 1), NEG), cum[:, :-1]], axis=1) - (
            (karr.astype(jnp.float32) - 1.0) * gap_ext
        )
        Hn = jnp.where(karr == 0, NEG, Hn)
        Hn = jnp.where(valid, Hn, NEG)

        M = jnp.where(valid, M, NEG)
        Vn = jnp.where(valid, Vn, NEG)
        Sn = jnp.maximum(M, jnp.maximum(Hn, Vn))

        # Choice: diag > horiz > vert on ties.
        choice = jnp.where(
            M >= Sn, 0, jnp.where(Hn >= Sn, 1, 2)
        ).astype(jnp.int8)
        # Horizontal extend bit: H came from H (k-1) rather than S (k-1).
        mv_prev = jnp.concatenate([jnp.full((P, 1), NEG), mv[:, :-1]], axis=1)
        h_prev = jnp.concatenate([jnp.full((P, 1), NEG), Hn[:, :-1]], axis=1)
        h_ext = h_prev - gap_ext >= mv_prev - gap_open
        dirs = (
            choice
            + (h_ext.astype(jnp.int8) << 2)
            + (v_ext.astype(jnp.int8) << 3)
        )

        S_out = jnp.where(alive, Sn, S)
        H_out = jnp.where(alive, Hn, H)
        V_out = jnp.where(alive, Vn, V)
        return (S_out, H_out, V_out), dirs

    (S, _, _), dirs = jax.lax.scan(
        row, (s0, h0, v0), jnp.arange(1, rows + 1, dtype=jnp.int32)
    )
    kfin = lens_b - lens_a - lo
    scores = jnp.take_along_axis(S, kfin[:, None], axis=1)[:, 0]
    return scores, dirs


@jax.jit
def _pair_walk_kernel(dirs, lens_a, lens_b, lo):
    """Batched on-device Gotoh walk, row-synchronized.

    A cell-at-a-time walk pays one big-table gather per step over the whole
    [P, rows*W] direction tensor, so path-length many steps would dominate
    the MSA.  Walking row-by-row instead lets ``lax.scan`` hand each step its
    row's direction slice for free; horizontal-gap runs resolve in one
    ``cummax`` over the row, and every remaining lookup is a small [P, W]
    gather.  The walker is at row ``r`` exactly at scan step ``r`` because
    every row exit (diag or vert) decrements the row by one.

    Returns jmat [rows, P] int32: for DP row i (1-based, stored at i-1) the
    matched B-position j if the path aligned (i, j), else 0 — ascending row
    order is ascending path order.
    """
    rows, P, W = dirs.shape
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    lo = jnp.asarray(lo, jnp.int32)
    k0 = lens_b - lens_a - lo  # band coordinate at (la, lb)
    karr = jnp.arange(W, dtype=jnp.int32)[None, :]

    def gather_k(mat, k):
        return jnp.take_along_axis(
            mat, jnp.clip(k, 0, W - 1)[:, None], axis=1
        )[:, 0]

    def row_step(carry, xs):
        k, st, dead = carry  # st: 0 = S, 2 = V (H never crosses rows)
        d_row, r = xs
        d_row = d_row.astype(jnp.int32)
        kz = -(r + lo)  # band coordinate where j == 0 on this row

        start = lens_a == r
        k = jnp.where(start, k0, k)
        st = jnp.where(start, 0, st)
        j_in = r + lo + k
        act = (r <= lens_a) & ~dead & (j_in > 0) & (lens_b > 0)

        choice = d_row & 3
        hext = (d_row >> 2) & 1
        # pz_h[k]: largest k' <= k whose hext is 0 — an H-run starting at k
        # ends one column below that cell (reference semantics: state stays H
        # while the *current* cell's extend bit is set).
        pz_h = jax.lax.cummax(jnp.where(hext == 0, karr, -1), axis=1)
        # ONE packed plane so each chain hop costs a single [P] gather (the
        # gathers dominate the walk): bits 0-1 choice, bit 2 vext,
        # bits 3+ pz_h + 1.
        pack = (
            (d_row & 3)
            | (((d_row >> 3) & 1) << 2)
            | ((pz_h + 1) << 3)
        )

        # V-state pairs: exactly one vertical move this row.
        is_v = act & (st == 2)
        v_vext = (gather_k(pack, k) >> 2) & 1

        # S-state pairs: resolve the within-row choice/H-run chain.
        is_s = act & (st == 0)
        f = jnp.zeros(P, dtype=bool)

        def cond(c):
            return jnp.any(c[0])

        def body(c):
            unresolved, kk, exit_diag, exit_vert, dd, _pk = c
            pk = gather_k(pack, kk)
            ch = pk & 3
            dg = unresolved & (ch == 0)
            vt = unresolved & (ch == 2)
            hz = unresolved & (ch == 1)
            kend = (pk >> 3) - 2  # pz_h at kk, minus one
            knew = jnp.where(hz, kend, kk)
            died = hz & ((knew <= kz) | (knew < 0))
            return (
                unresolved & ~dg & ~vt & ~died,
                knew,
                exit_diag | dg,
                exit_vert | vt,
                dd | died,
                jnp.where(unresolved, pk, _pk),
            )

        pk0 = jnp.zeros(P, jnp.int32)
        _, k_s, exit_diag, exit_vert, died_s, pk_s = jax.lax.while_loop(
            cond, body, (is_s, k, f, f, f, pk0)
        )

        # int16 halves the jmat readback (j <= column count << 32767).
        j_emit = jnp.where(exit_diag, r + lo + k_s, 0).astype(jnp.int16)
        # pk_s is the pack at each pair's RESOLVING position (the last hop
        # where it was still unresolved) == pack at k_s, so the vext bit
        # needs no extra gather.
        s_vext = (pk_s >> 2) & 1
        k_after_s = jnp.where(exit_vert, k_s + 1, k_s)
        st_after_s = jnp.where(exit_vert & (s_vext == 1), 2, 0)

        k_next = jnp.where(is_v, k + 1, jnp.where(is_s, k_after_s, k))
        st_next = jnp.where(
            is_v,
            jnp.where(v_vext == 1, 2, 0),
            jnp.where(is_s, st_after_s, st),
        )
        return (k_next, st_next, dead | died_s), j_emit

    init = (
        jnp.zeros(P, jnp.int32),
        jnp.zeros(P, jnp.int32),
        jnp.zeros(P, dtype=bool),
    )
    return _blocked_row_scan(row_step, init, dirs, rows, P)


def _blocked_row_scan(row_step, init, dirs, rows, P, block: int = 8):
    """Run a reverse row walk with ``block`` rows unrolled per scan step.

    Loop iterations are latency-bound (tiny bodies), so fusing 8 rows per
    step cuts the fixed per-iteration cost 8x.  ``rows`` (a power-of-two
    bucket) must be divisible by ``block``.
    """
    nblk = rows // block
    dirs_b = dirs.reshape(nblk, block, *dirs.shape[1:])
    rows_b = jnp.arange(1, rows + 1, dtype=jnp.int32).reshape(nblk, block)

    def blk_step(carry, xs):
        d_blk, r_blk = xs
        emits = [None] * block
        for u in range(block - 1, -1, -1):  # reverse within the block
            carry, emits[u] = row_step(carry, (d_blk[u], r_blk[u]))
        return carry, jnp.stack(emits)

    _, jmat = jax.lax.scan(blk_step, init, (dirs_b, rows_b), reverse=True)
    return jmat.reshape(rows, P)


def _compact_jmat(jmat: np.ndarray, n: int) -> list:
    """[(ai, bi)] matched-position pairs (ascending) from a walk's jmat."""
    out = []
    for q in range(n):
        col = jmat[:, q]
        rr = np.flatnonzero(col)
        out.append(((rr + 1).astype(np.int32), col[rr].astype(np.int32)))
    return out


def _pair_inflight_budget() -> int:
    """Max bytes of queued-but-uncollected pair-DP direction tensors:
    ~3/16 of free device memory at first probe, since PJRT allocates every
    queued launch's buffers at enqueue time.  The fraction was chosen on
    earlier hardware and has not yet been measured on the GPU."""
    from ..utils.membudget import device_memory_budget

    return device_memory_budget("pair_inflight", 3 / 16, 3 << 30)


def _bkt_pow2(x: int, base: int) -> int:
    b = base
    while b < x:
        b *= 2
    return b


def _pair_chunk(rows_b: int, W_b: int, budget: int = 1 << 30) -> int:
    """Max pairs per banded-DP launch so the [rows, P, W] int8 direction
    tensor stays under ``budget`` bytes — one unchunked 50k-pair bucket at
    rows=1024, W=256 would ask the chip for >10 GB and OOM (r3 10k-read
    pipeline).  Power-of-two so compiled programs stay bounded."""
    p = budget // max(rows_b * W_b, 1)
    c = 128
    while c * 2 <= p:
        c *= 2
    return c


def _run_pair_bucket(
    codes_a, lens_a, codes_b, lens_b, lo, hi,
    match, mismatch, gap_open, gap_ext, bandwidth, rows_b, W_b,
):
    """One shape-bucketed launch (DP + on-device walk).

    With an active mesh (:mod:`..parallel.context`) the pair axis is padded
    to a mesh multiple and sharded, so the banded DP + walk run data-parallel
    over devices (each pair is independent — no collectives).
    """
    from ..parallel.context import active_mesh, mesh_size

    P = codes_a.shape[0]

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    Pp = _bkt(max(P, 1), 8)
    mesh = active_mesh()
    if mesh is not None:
        m = mesh_size(mesh)
        Pp += (-Pp) % m
    la_b = _bkt(max(int(lens_a.max()) if P else 1, 1), 64)
    lb_b = _bkt(max(int(lens_b.max()) if P else 1, 1), 64)

    def _pad2(a, n, w, fill):
        out = np.full((n, w), fill, a.dtype)
        out[: a.shape[0], : min(a.shape[1], w)] = a[:, :w]
        return out

    codes_a_p = _pad2(np.asarray(codes_a), Pp, la_b, 5)
    codes_b_p = _pad2(np.asarray(codes_b), Pp, lb_b, 5)
    lens_a_p = np.zeros(Pp, np.int32)
    lens_a_p[:P] = lens_a
    lens_b_p = np.zeros(Pp, np.int32)
    lens_b_p[:P] = lens_b
    lo_p = np.full(Pp, -bandwidth, np.int32)
    lo_p[:P] = lo
    hi_p = np.full(Pp, bandwidth, np.int32)
    hi_p[:P] = hi

    from ..parallel.context import shard_batch

    ca_d, cb_d, la_d, lb_d, lo_d, km_d = shard_batch(
        np.asarray(codes_a_p, np.int32),
        np.asarray(codes_b_p, np.int32),
        lens_a_p,
        lens_b_p,
        lo_p,
        (hi_p - lo_p),
    )
    scores, dirs = _banded_pair_kernel(
        jnp.asarray(ca_d),
        jnp.asarray(cb_d),
        jnp.asarray(la_d),
        jnp.asarray(lb_d),
        jnp.asarray(lo_d),
        jnp.asarray(km_d),
        float(match),
        float(mismatch),
        float(gap_open),
        float(gap_ext),
        rows=rows_b,
        width=W_b,
    )
    # Walk on device; transfer only the per-row matched positions.  The
    # return values are undelivered device arrays — jax dispatch is async,
    # so the caller can queue every bucket before paying any readback.
    jmat = _pair_walk_kernel(
        dirs, jnp.asarray(lens_a_p), jnp.asarray(lens_b_p), jnp.asarray(lo_p)
    )
    ident = _pair_ident_kernel(
        jmat, jnp.asarray(codes_a_p, jnp.int32), jnp.asarray(codes_b_p, jnp.int32)
    )
    return scores, jmat, ident


@jax.jit
def _pair_ident_kernel(jmat, codes_a, codes_b):
    """Fractional identity per pair from the walk's jmat, on device.

    jmat [rows, P] (row r-1 = matched B-position for A-position r, 0 = none);
    codes_* [P, L]. frac = (#matched positions with equal bases) / #matched,
    0 when nothing matched — reproducing _pair_post's host computation.
    """
    rows, P = jmat.shape
    jm = jmat.T.astype(jnp.int32)  # [P, rows]
    matched = jm > 0
    take = min(rows, codes_a.shape[1])
    ca = jnp.zeros((P, rows), jnp.int32).at[:, :take].set(codes_a[:, :take])
    lb = codes_b.shape[1]
    cb = jnp.take_along_axis(codes_b, jnp.clip(jm - 1, 0, lb - 1), axis=1)
    eq = matched & (ca == cb)
    cnt = matched.sum(axis=1)
    return eq.sum(axis=1).astype(jnp.float32) / jnp.maximum(cnt, 1).astype(jnp.float32)


def banded_pair_align(
    codes_a: np.ndarray,
    lens_a: np.ndarray,
    codes_b: np.ndarray,
    lens_b: np.ndarray,
    match: float,
    mismatch: float,
    gap_open: float,
    gap_ext: float,
    bandwidth: int,
    stage: str = "msa.pair_library",
):
    """Batch of banded global pairwise alignments.

    Pairs are partitioned into (rows, band-width) shape classes so that one
    ragged batch doesn't inflate everyone's DP to the worst case; each class
    is one device launch.  Returns (scores [P] float, paths: list of
    (ai, bi) matched-position arrays, 1-based).
    """
    P = codes_a.shape[0]
    lens_a = np.asarray(lens_a, np.int32)
    lens_b = np.asarray(lens_b, np.int32)
    if P == 0:
        return np.zeros(0), []
    diffs = lens_b.astype(np.int64) - lens_a.astype(np.int64)
    lo = (np.minimum(0, diffs) - bandwidth).astype(np.int32)
    hi = (np.maximum(0, diffs) + bandwidth).astype(np.int32)

    def _bkt_arr(x, base):
        out = np.full_like(x, base)
        while True:
            small = out < x
            if not small.any():
                return out
            out[small] *= 2

    rows_c = _bkt_arr(np.maximum(lens_a.astype(np.int64), 1), 64)
    W_c = _bkt_arr((hi - lo + 1).astype(np.int64), 64)

    scores = np.zeros(P, np.float64)
    paths: list = [None] * P
    # Phase 1: dispatch every bucket (async — each launch queues behind the
    # previous one on device).  Phase 2: read back.  This overlaps the
    # device compute of later buckets with the readback of earlier ones.
    from ..utils.profiling import StageStats, get_profiler

    # Counters land on the caller's timed stage (default msa.pair_library)
    # so the report shows real pairs/s and banded-DP GCUPS.
    dpstat = get_profiler().stages.setdefault(stage, StageStats())
    dpstat.items += P
    dpstat.cells += int((rows_c.astype(np.int64) * W_c).sum())
    from ..utils.profiling import profiler as _prof

    def _collect(item):
        idx, sc_dev, jmat_dev, _ = item
        with _prof("msa.pair_walk"):
            scores[idx] = np.asarray(sc_dev, np.float64)[: idx.size]
            pt = _compact_jmat(np.asarray(jmat_dev), idx.size)
            for k, i in enumerate(idx):
                paths[i] = pt[k]

    # Byte-budgeted in-flight window: PJRT allocates every queued launch's
    # output/intermediate buffers at ENQUEUE time, so dispatching all
    # buckets before any readback holds every bucket's [rows, P, W]
    # direction tensor at once (~1 GiB each — the 10k-read pipeline OOMed
    # exactly here).  Collecting the oldest bucket blocks until its walk
    # ran, which frees its dirs and everything queued before it.
    inflight: list = []
    inflight_bytes = 0
    inflight_budget = _pair_inflight_budget()
    for key in sorted(set(zip(rows_c.tolist(), W_c.tolist()))):
        idx = np.flatnonzero((rows_c == key[0]) & (W_c == key[1]))
        for c0 in range(0, idx.size, _pair_chunk(int(key[0]), int(key[1]))):
            sub = idx[c0 : c0 + _pair_chunk(int(key[0]), int(key[1]))]
            sc_dev, jmat_dev, _ = _run_pair_bucket(
                codes_a[sub], lens_a[sub], codes_b[sub], lens_b[sub],
                lo[sub], hi[sub], match, mismatch, gap_open, gap_ext,
                bandwidth, int(key[0]), int(key[1]),
            )
            nbytes = int(key[0]) * _bkt_pow2(sub.size, 8) * int(key[1])
            inflight.append((sub, sc_dev, jmat_dev, nbytes))
            inflight_bytes += nbytes
            while inflight_bytes > inflight_budget and len(inflight) > 1:
                inflight_bytes -= inflight[0][3]
                _collect(inflight.pop(0))
    for item in inflight:
        _collect(item)
    return scores, paths


@functools.partial(jax.jit, static_argnames=("rows", "width"))
def _profile_merge_kernel(cost, lens_a, lens_b, lo, kmax, rows: int, width: int):
    """Gapless maximal-weighted-trace DP over banded column-score planes.

    cost: [P, rows, W] float — cost[p, i-1, k] is the column score of
    aligning profile-A column i with profile-B column j = i + lo + k.
    Returns (scores [P], dirs [rows, P, W] int8: 0 diag, 1 horiz, 2 vert).
    """
    P = cost.shape[0]
    W = width
    karr = jnp.arange(W, dtype=jnp.int32)[None, :]

    in_band = karr <= kmax[:, None]
    s0 = jnp.where(jnp.logical_and(lo[:, None] + karr >= 0, in_band), 0.0, NEG)

    def row(S, c, i):
        j = i + lo[:, None] + karr
        valid = jnp.logical_and(jnp.logical_and(j >= 0, j <= lens_b[:, None]), in_band)
        alive = i <= lens_a[:, None]

        M = S + jnp.where(jnp.logical_and(j >= 1, j <= lens_b[:, None]), c, NEG)
        S_up = jnp.concatenate([S[:, 1:], jnp.full((P, 1), NEG)], axis=1)  # vert
        D = jnp.maximum(M, S_up)
        # Horizontal closes the row: running max along k.
        Sn = jax.lax.cummax(D, axis=1)
        Sn = jnp.where(valid, Sn, NEG)
        choice = jnp.where(M >= Sn, 0, jnp.where(S_up >= Sn, 2, 1)).astype(jnp.int8)
        S_out = jnp.where(alive, Sn, S)
        return S_out, choice

    # 8 rows per scan step: the row bodies are tiny, so per-iteration
    # dispatch latency dominates the sequential scan — unrolling amortizes
    # it (rows is a power-of-two bucket, divisible by 8).
    block = 8
    nblk = rows // block
    cost_b = cost.reshape(P, nblk, block, W).transpose(1, 2, 0, 3)
    ivals = jnp.arange(1, rows + 1, dtype=jnp.int32).reshape(nblk, block)

    def blk(S, xs):
        c_blk, i_blk = xs
        outs = []
        for u in range(block):
            S, ch = row(S, c_blk[u], i_blk[u])
            outs.append(ch)
        return S, jnp.stack(outs)

    S, dirs = jax.lax.scan(blk, s0, (cost_b, ivals))
    dirs = dirs.reshape(rows, P, W)
    kfin = lens_b - lens_a - lo
    scores = jnp.take_along_axis(S, kfin[:, None], axis=1)[:, 0]
    return scores, dirs


def _walk_merge(dirs_rw: np.ndarray, la: int, lb: int, lo: int):
    """Walk one merge's choice matrix; horiz moves j-1 (k-1), vert i-1 (k+1)."""
    ai, bi = [], []
    i, j = la, lb
    while i > 0 and j > 0:
        k = j - i - lo
        c = int(dirs_rw[i - 1, k])
        if c == 0:
            ai.append(i)
            bi.append(j)
            i -= 1
            j -= 1
        elif c == 1:
            j -= 1
        else:
            i -= 1
    return np.asarray(ai[::-1], np.int32), np.asarray(bi[::-1], np.int32)


def banded_profile_merge_many(costs, las, lbs, los):
    """Batch of profile merges, partitioned into (rows, W) shape classes so
    one long merge doesn't inflate the padded upload for every other merge
    (the cost planes dominate host->device traffic).

    ``costs[p]`` is [la_p, W_p] float32; returns list of (ai, bi) matched
    column arrays per merge.
    """
    P = len(costs)
    if P == 0:
        return []

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    classes: dict[tuple[int, int], list[int]] = {}
    for p in range(P):
        key = (_bkt(max(int(las[p]), 1), 64), _bkt(costs[p].shape[1], 64))
        classes.setdefault(key, []).append(p)
    if len(classes) > 1:
        out: list = [None] * P
        for (rb, wb), idxs in classes.items():
            sub = _merge_bucket(
                [costs[i] for i in idxs],
                [las[i] for i in idxs],
                [lbs[i] for i in idxs],
                [los[i] for i in idxs],
                rb,
                wb,
            )
            for k, i in enumerate(idxs):
                out[i] = sub[k]
        return out
    (rows_b, W_b), = classes.keys()
    return _merge_bucket(costs, las, lbs, los, rows_b, W_b)


def _merge_bucket(costs, las, lbs, los, rows_b, W_b):
    P = len(costs)

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    Pp = _bkt(P, 4)

    cost = np.full((Pp, rows_b, W_b), NEG, np.float32)
    for p, c in enumerate(costs):
        cost[p, : c.shape[0], : c.shape[1]] = c
    la = np.zeros(Pp, np.int32)
    la[:P] = las
    lb = np.zeros(Pp, np.int32)
    lb[:P] = lbs
    lo = np.zeros(Pp, np.int32)
    lo[:P] = los

    kmax = np.zeros(Pp, np.int32)
    kmax[:P] = [c.shape[1] - 1 for c in costs]
    _, dirs = _profile_merge_kernel(
        jnp.asarray(cost),
        jnp.asarray(la),
        jnp.asarray(lb),
        jnp.asarray(lo),
        jnp.asarray(kmax),
        rows=rows_b,
        width=W_b,
    )
    dirs = np.asarray(dirs)
    return [
        _walk_merge(dirs[:, p, :], int(las[p]), int(lbs[p]), int(los[p]))
        for p in range(P)
    ]


def banded_profile_merge(cost: np.ndarray, la: int, lb: int, lo: int):
    """One merge (P=1 convenience wrapper): returns the matched column pairs."""
    return banded_profile_merge_many([cost], [la], [lb], [lo])[0]


@jax.jit
def _merge_walk_kernel(dirs, lens_a, lens_b, lo):
    """On-device walk for profile merges (choice-only: 0 diag, 1 horiz,
    2 vert), row-synchronized like :func:`_pair_walk_kernel`.

    Simpler than the Gotoh walk: a horizontal run is the consecutive
    ``choice == 1`` cells below the entry column and always ends *on* the
    first non-horizontal cell, which then exits the row via diag or vert.

    Returns jmat [rows, P] int32 (see :func:`_pair_walk_kernel`).
    """
    rows, P, W = dirs.shape
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    lo = jnp.asarray(lo, jnp.int32)
    karr = jnp.arange(W, dtype=jnp.int32)[None, :]
    k0 = lens_b - lens_a - lo

    def gather_k(mat, k):
        return jnp.take_along_axis(mat, jnp.clip(k, 0, W - 1)[:, None], axis=1)[:, 0]

    def row_step(carry, xs):
        k, dead = carry
        d_row, r = xs
        d_row = d_row.astype(jnp.int32)
        kz = -(r + lo)

        start = lens_a == r
        k = jnp.where(start, k0, k)
        j_in = r + lo + k
        act = (r <= lens_a) & ~dead & (j_in > 0) & (lens_b > 0)

        # First k' <= k with choice != 1: where the horizontal run ends.
        pz = jax.lax.cummax(jnp.where(d_row != 1, karr, -1), axis=1)
        kf = gather_k(pz, k)
        died = act & ((kf <= kz) | (kf < 0))
        ok = act & ~died
        ch = gather_k(d_row, kf)
        dg = ok & (ch == 0)
        vt = ok & (ch == 2)
        j_emit = jnp.where(dg, r + lo + kf, 0).astype(jnp.int16)
        k_next = jnp.where(dg, kf, jnp.where(vt, kf + 1, k))
        return (k_next, dead | died), j_emit

    init = (jnp.zeros(P, jnp.int32), jnp.zeros(P, dtype=bool))
    return _blocked_row_scan(row_step, init, dirs, rows, P)


@functools.partial(jax.jit, static_argnames=("P", "rows", "width"))
def _merge_cost_init(la, kmax, P: int, rows: int, width: int):
    """NEG outside the band/live rows, 0 inside — the DP's blank planes."""
    karr = jnp.arange(width, dtype=jnp.int32)
    in_band = karr[None, None, :] <= kmax[:, None, None]
    live_rows = (
        jnp.arange(1, rows + 1, dtype=jnp.int32)[None, :, None]
        <= la[:, None, None]
    )
    return jnp.where(in_band & live_rows, 0.0, jnp.float32(NEG)) * jnp.ones(
        (P, 1, 1), jnp.float32
    )


@functools.partial(jax.jit, donate_argnums=(2,), static_argnames=("EC",))
def _merge_accum_kernel(
    lib_tab,  # [T, 3] uint16 device library rows (pa, pb, wq), uploaded once
    w_inv,  # uint16 weight dequantization factor
    cost,  # [P, rows, width] f32 accumulator (donated)
    seg_bound,  # [S] int32 absolute start entry of each segment
    seg_delta,  # [7, S] int32 first-difference table: off, m, aoff, boff,
    #             swap, lo, kmax (value of segment i = prefix sum of deltas)
    p2ca, p2cb,  # flat position->column maps (0 = unmapped), int16
    total,  # scalar int32 device: real entry count
    e0,  # scalar int32 device: this chunk's first entry
    EC: int,
):
    """Accumulate one chunk of library entries into the wave's cost planes.

    Per-segment data is piecewise-constant over the entry axis, so instead
    of a per-entry [E, 9] int32 row gather (a large padded intermediate at
    E = 33M entries) each
    quantity is rebuilt with ONE boundary scatter + a lane-wise cumsum:
    deltas land at each segment's chunk-relative start (clamped to 0 for
    segments starting before the chunk, dropped past its end) and prefix-sum
    to the per-entry value.  O(S + EC) with no gather; the only per-entry
    gathers left are the [EC, 3] library row gather and the two map
    lookups, all bounded by the chunk size.

    Entry ``e``'s library row is ``t = off_seg + e`` (entries of a segment
    are contiguous in the table), and its cost contribution lands at
    ``cost[m, ci - 1, cj - ci - lo]`` through the position->column maps.
    """
    P, rows, width = cost.shape
    S = seg_bound.shape[0]
    e = e0 + jnp.arange(EC, dtype=jnp.int32)
    b = seg_bound - e0  # chunk-relative boundary of each segment
    bpos = jnp.where(b >= EC, EC, jnp.maximum(b, 0))  # EC drops via mode
    qidx = jnp.repeat(jnp.arange(7, dtype=jnp.int32), S)
    arr = jnp.zeros((7, EC), jnp.int32).at[
        qidx, jnp.tile(bpos, 7)
    ].add(seg_delta.reshape(-1), mode="drop")
    vals = jnp.cumsum(arr, axis=1)  # [7, EC]
    off, m, s_aoff, s_boff = vals[0], vals[1], vals[2], vals[3]
    sw, lo_m, kmax_m = vals[4] == 1, vals[5], vals[6]

    t = jnp.clip(off + e, 0, lib_tab.shape[0] - 1)
    valid_e = e < total

    lr = lib_tab[t].astype(jnp.int32)  # [EC, 3] one row gather per entry
    pa_raw, pb_raw, wq = lr[:, 0], lr[:, 1], lr[:, 2]
    pa_e = jnp.where(sw, pb_raw, pa_raw)  # position on the A-side member
    pb_e = jnp.where(sw, pa_raw, pb_raw)
    w_e = wq.astype(jnp.float32) * w_inv
    ci = p2ca[jnp.clip(s_aoff + pa_e, 0, p2ca.shape[0] - 1)].astype(jnp.int32)
    cj = p2cb[jnp.clip(s_boff + pb_e, 0, p2cb.shape[0] - 1)].astype(jnp.int32)
    k = cj - ci - lo_m
    ok = (
        valid_e
        & (ci >= 1)
        & (cj >= 1)
        & (k >= 0)
        & (k <= kmax_m)
        & (k < width)
        & (ci <= rows)
    )
    return cost.at[
        jnp.where(ok, m, P),
        jnp.clip(ci - 1, 0, rows - 1),
        jnp.clip(k, 0, width - 1),
    ].add(jnp.where(ok, w_e, 0.0), mode="drop")


@jax.jit
def _merge_dp_walk(cost, la, lb, lo, kmax):
    """Banded merge DP + device walk over finished cost planes."""
    P, rows, width = cost.shape
    _, dirs = _profile_merge_kernel(
        cost, la, lb, lo, kmax, rows=rows, width=width
    )
    return _merge_walk_kernel(dirs, la, lb, lo)


@functools.partial(jax.jit, static_argnames=("T",))
def _pack_jmat_kernel(jmat, starts, cols, T: int):
    """Pack each merge's leading ``la`` jmat rows into one flat int16 run.

    The raw wave jmat is [rows_b, Pp] with pow2 padding on both axes —
    reading it back whole moves ~3x the real path data.  ``starts`` [S+1] is the
    exclusive scan of the per-merge row counts (starts[S] = total);
    ``cols`` [S] maps segments to jmat columns.  Output element t is
    ``jmat[t - starts[m], cols[m]]`` for t's segment m — segment lookup is
    a tiny scatter + cumsum.
    """
    rows, _ = jmat.shape
    marks = jnp.zeros(T + 1, jnp.int32).at[jnp.clip(starts[1:], 0, T)].add(1)
    m_of_t = jnp.cumsum(marks)[:T]
    t_arr = jnp.arange(T, dtype=jnp.int32)
    row = t_arr - starts[jnp.minimum(m_of_t, starts.shape[0] - 1)]
    col = cols[jnp.minimum(m_of_t, cols.shape[0] - 1)]
    return jmat[jnp.clip(row, 0, rows - 1), col]


#: Entries per _merge_accum_kernel launch: bounds the chunk's per-entry
#: temporaries ([EC, 3]-row-gather padding included) to a few hundred MB.
MERGE_ENTRY_CHUNK = 1 << 21


def merge_wave_from_library(lib_dev, merges_desc, rows_b, W_b):
    """Run one shape-class wave of profile merges against the device library.

    ``lib_dev`` = ([T, 3] uint16 device row table (pa, pb, quantized w),
    dequantization factor), uploaded once per multi_read_align call.
    ``merges_desc`` is a list of dicts with keys
    ``la, lb, lo, kmax, segments, p2ca, p2cb`` where ``segments`` is a list
    of (start, length, aoff, boff, swap) tuples referencing the library and
    the merge-local concatenated column maps.  Returns the (undelivered)
    device jmat [rows_b, Pp]; the caller reads it back with np.asarray and
    decodes with :func:`_compact_jmat` — keeping the launch async so
    several shape classes can be queued before any readback.
    """
    P = len(merges_desc)
    if P == 0:
        return None

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    Pp = _bkt(P, 16)  # coarse: the DP scan is latency-, not FLOP-, bound
    la = np.zeros(Pp, np.int32)
    lb = np.zeros(Pp, np.int32)
    lo = np.zeros(Pp, np.int32)
    kmax = np.zeros(Pp, np.int32)
    segs = []
    p2ca_parts, p2cb_parts = [], []
    aoff_global = boff_global = 0
    for m, d in enumerate(merges_desc):
        la[m], lb[m], lo[m], kmax[m] = d["la"], d["lb"], d["lo"], d["kmax"]
        for (start, length, aoff, boff, swap) in d["segments"]:
            segs.append(
                (start, length, m, aoff_global + aoff, boff_global + boff, swap)
            )
        p2ca_parts.append(d["p2ca"])
        p2cb_parts.append(d["p2cb"])
        aoff_global += d["p2ca"].size
        boff_global += d["p2cb"].size

    # int32 throughout: jax runs without x64 by default, and every quantity
    # (library offsets < ~100M, map offsets, lengths) fits in 31 bits.
    # Per-segment values travel as a first-difference table: the accumulate
    # kernel rebuilds them per entry with one scatter + cumsum (no row
    # gather — see _merge_accum_kernel).  COARSE pow2 buckets everywhere:
    # every distinct (S, PM, EC, cost-shape) tuple is a separate compile,
    # and a deep run issues hundreds of waves.
    S = _bkt(max(len(segs), 1), 4096)
    vals = np.zeros((7, S), np.int32)  # off, m, aoff, boff, sw, lo, kmax
    bound = np.zeros(S, np.int32)
    at = 0
    for i, (st, ln, m, ao, bo, sw) in enumerate(segs):
        bound[i] = at
        vals[:, i] = (st - at, m, ao, bo, sw, lo[m], kmax[m])
        at += ln
    total = at
    if len(segs) < S:  # padded segments: zero-length, stacked at the end
        bound[len(segs):] = total
        vals[:, len(segs):] = vals[:, len(segs) - 1 : len(segs)] if segs else 0
    seg_delta = np.concatenate(
        [vals[:, :1], np.diff(vals, axis=1)], axis=1
    ).astype(np.int32)

    def _cat(parts):
        return np.concatenate(parts) if parts else np.zeros(1, np.int32)

    p2ca_flat = _cat(p2ca_parts)
    p2cb_flat = _cat(p2cb_parts)
    # ONE shared pow2 bucket for both maps: separate buckets cross-multiply
    # into the accumulate kernel's compile count.
    PM = _bkt(max(p2ca_flat.size, p2cb_flat.size, 1), 1 << 16)
    p2ca = np.zeros(PM, np.int16)
    p2ca[: p2ca_flat.size] = p2ca_flat
    p2cb = np.zeros(PM, np.int16)
    p2cb[: p2cb_flat.size] = p2cb_flat

    from ..utils.profiling import profiler as _prof

    with _prof("msa.merge_upload"):
        # Column maps are the per-wave transfer; int16 halves them (column
        # indices are bounded by the merged profile width << 32767).
        p2ca_dev = jnp.asarray(p2ca)
        p2cb_dev = jnp.asarray(p2cb)
        bound_dev = jnp.asarray(bound)
        delta_dev = jnp.asarray(seg_delta)
        total_dev = jnp.asarray(total, jnp.int32)
    with _prof("msa.merge_dispatch"):
        la_d, lb_d = jnp.asarray(la), jnp.asarray(lb)
        lo_d, km_d = jnp.asarray(lo), jnp.asarray(kmax)
        cost = _merge_cost_init(la_d, km_d, P=Pp, rows=rows_b, width=W_b)
        # Two chunk classes only (compile count): small waves take one 64k
        # launch, big waves stream 2M chunks (a partial tail chunk wastes
        # at most ~0.2 s of masked scatter work).
        EC = (1 << 16) if total <= (1 << 16) else MERGE_ENTRY_CHUNK
        for c0 in range(0, max(total, 1), EC):
            cost = _merge_accum_kernel(
                *lib_dev, cost, bound_dev, delta_dev, p2ca_dev, p2cb_dev,
                total_dev, np.int32(c0), EC=EC,
            )
        return _merge_dp_walk(cost, la_d, lb_d, lo_d, km_d)


# ---------------------------------------------------------------------------
# Device-resident T-Coffee library: the pair walks' jmats ARE the dense
# position maps, so the consistency (triplet) extension is pure gather /
# tiny-sort work on device — the extended library (the framework's largest
# tensor, ~6x the base library) never crosses the host<->device link.
# ---------------------------------------------------------------------------

ARENA_ZERO_ROW = 0  # all zeros: composing through it yields dead entries
ARENA_IDENT_ROW = 1  # identity map: lets the base entries reuse the
# composition kernel (x->y base == x->y map composed with identity)


def pair_maps_device(
    codes, lengths, ga, gb,
    match, mismatch, gap_open, gap_ext, bandwidth,
):
    """Align all (ga[i], gb[i]) read pairs; keep every path on device.

    ``codes`` [n, L] int8 host reads; each bucket chunk uploads the code
    rows of its own pairs.

    Returns (arena [2 + 2J, stride] int16, stride, fracs [J] float64):
    job i's forward map (A-position -> matched B-position, 0 = none) is
    arena row ``2 + 2i``; the reverse map is row ``3 + 2i``.  ``fracs`` is
    the per-pair fractional identity (host numpy; it feeds the guide tree).
    """
    J = ga.shape[0] if hasattr(ga, "shape") else len(ga)
    ga = np.asarray(ga, np.int64)
    gb = np.asarray(gb, np.int64)
    lengths = np.asarray(lengths)
    lens_a = lengths[ga].astype(np.int32) if J else np.zeros(0, np.int32)
    lens_b = lengths[gb].astype(np.int32) if J else np.zeros(0, np.int32)

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    diffs = lens_b.astype(np.int64) - lens_a.astype(np.int64)
    lo = (np.minimum(0, diffs) - bandwidth).astype(np.int32)
    hi = (np.maximum(0, diffs) + bandwidth).astype(np.int32)

    def _bkt_arr(x, base):
        out = np.full_like(x, base)
        while True:
            small = out < x
            if not small.any():
                return out
            out[small] *= 2

    rows_c = _bkt_arr(np.maximum(lens_a.astype(np.int64), 1), 64) if J else np.zeros(0, np.int64)
    W_c = _bkt_arr((hi - lo + 1).astype(np.int64), 64) if J else np.zeros(0, np.int64)

    from ..utils.profiling import StageStats, get_profiler

    dpstat = get_profiler().stages.setdefault("msa.pair_library", StageStats())
    dpstat.items += J
    dpstat.cells += int((rows_c * W_c).sum()) if J else 0

    # Power-of-two buckets on every shape so recompiles stay bounded.  The
    # arena indexes REAL positions (<= max sequence length), not padded DP
    # rows — stride directly scales every extension chunk's work.
    lmax = int(max(lens_a.max(initial=1), lens_b.max(initial=1)))
    stride = _bkt(lmax + 1, 128)
    if J == 0:
        arena = jnp.zeros((64, stride), jnp.int16)
        arena = arena.at[ARENA_IDENT_ROW].set(
            jnp.arange(stride, dtype=jnp.int16)
        )
        return arena, stride, np.zeros(0, np.float64), np.zeros(0, np.int64)

    fracs = np.zeros(J, np.float64)

    def _place(item):
        nonlocal arena
        idx, rows_b, jmat_dev, ident_dev, _, slab = item
        arena = _arena_place_kernel(arena, jmat_dev, np.int32(slab), rows=rows_b)
        fracs[idx] = np.asarray(ident_dev, np.float64)[: idx.size]

    # Byte-budgeted in-flight window — see banded_pair_align: queued
    # launches hold their [rows, P, W] dirs from enqueue until their walk
    # runs, so an unbounded dispatch loop OOMs at ~10k-read scale.
    from ..utils.profiling import profiler as _prof

    from ..parallel.context import active_mesh, mesh_size

    codes = np.asarray(codes)
    mesh0 = active_mesh()

    # Pre-pass: assign every bucket chunk a CONTIGUOUS arena slab (rows
    # 0 = zero map, 1 = identity, then 2 rows per dispatched pair slot in
    # dispatch order) so placement is one dynamic_update_slice DMA instead
    # of scalar scatters.  Slabs reserve the worst-case padded pair count;
    # unwritten slack rows stay zero and are never referenced.
    chunk_list = []
    arow = np.zeros(J, np.int64)
    next_row = 2
    for key in sorted(set(zip(rows_c.tolist(), W_c.tolist()))):
        idx = np.flatnonzero((rows_c == key[0]) & (W_c == key[1]))
        for c0 in range(0, idx.size, _pair_chunk(int(key[0]), int(key[1]))):
            sub = idx[c0 : c0 + _pair_chunk(int(key[0]), int(key[1]))]
            pb = _bkt_pow2(sub.size, 8)
            if mesh0 is not None:
                pb += (-pb) % mesh_size(mesh0)
            arow[sub] = next_row + 2 * np.arange(sub.size)
            chunk_list.append((key, sub, next_row))
            next_row += 2 * pb
    R = _bkt(next_row, 64)
    arena = jnp.zeros((R, stride), jnp.int16)
    arena = arena.at[ARENA_IDENT_ROW].set(jnp.arange(stride, dtype=jnp.int16))

    inflight: list = []
    inflight_bytes = 0
    inflight_budget = _pair_inflight_budget()
    for key, sub, slab in chunk_list:
        with _prof("msa.pair_dispatch"):
            _, jmat_dev, ident_dev = _run_pair_bucket(
                codes[ga[sub]], lens_a[sub], codes[gb[sub]],
                lens_b[sub], lo[sub], hi[sub], match, mismatch,
                gap_open, gap_ext, bandwidth, int(key[0]), int(key[1]),
            )
        nbytes = int(key[0]) * _bkt_pow2(sub.size, 8) * int(key[1])
        inflight.append((sub, int(key[0]), jmat_dev, ident_dev, nbytes, slab))
        inflight_bytes += nbytes
        while inflight_bytes > inflight_budget and len(inflight) > 1:
            inflight_bytes -= inflight[0][4]
            with _prof("msa.pair_place"):
                _place(inflight.pop(0))
    for item in inflight:
        with _prof("msa.pair_place"):
            _place(item)
    return arena, stride, fracs, arow


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("rows",))
def _arena_place_kernel(arena, jmat, row0, rows: int):
    """Place one bucket's jmats into a CONTIGUOUS arena slab at ``row0``.

    Bucket slabs are contiguous (pair_maps_device assigns arena rows in
    dispatch order), so the write
    is ONE dynamic_update_slice DMA of the interleaved fwd/rev planes, and
    the reverse maps build gather-only: matched (b, a) pairs sort by b per
    pair row (paths are monotone, so b values are unique and sorted search
    is exact) and a vectorized binary search spreads them over the b axis.

    DP rows beyond ``stride - 1`` are padding (positions never exceed the
    true max length the stride was sized from) and are sliced away.
    """
    Pb = jmat.shape[1]
    stride = arena.shape[1]
    take = min(rows, stride - 1)
    fwd = jnp.zeros((Pb, stride), arena.dtype)
    fwd = jax.lax.dynamic_update_slice(
        fwd, jmat.T[:, :take].astype(arena.dtype), (0, 1)
    )
    cols = fwd[:, 1 : take + 1].astype(jnp.int32)  # matched b per a (0 dead)

    BIG = jnp.int32(1) << 24
    keyb = jnp.where(cols > 0, cols, BIG)
    avals = jnp.broadcast_to(
        jnp.arange(1, take + 1, dtype=jnp.int32)[None, :], cols.shape
    )
    bs, a_of = jax.lax.sort((keyb, avals), dimension=1, num_keys=1)
    barr = jnp.arange(stride, dtype=jnp.int32)[None, :]
    lo = jnp.zeros((Pb, stride), jnp.int32)
    hi = jnp.full((Pb, stride), take, jnp.int32)
    steps = 1
    while (1 << steps) < take + 1:
        steps += 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(bs, jnp.minimum(mid, take - 1), axis=1)
        lt = v < barr
        lo = jnp.where(lt, mid + 1, lo)
        hi = jnp.where(lt, hi, mid)
    idx = jnp.minimum(lo, take - 1)
    v = jnp.take_along_axis(bs, idx, axis=1)
    a_at = jnp.take_along_axis(a_of, idx, axis=1)
    rev = jnp.where(v == barr, a_at, 0).astype(arena.dtype)

    inter = jnp.stack([fwd, rev], axis=1).reshape(2 * Pb, stride)
    return jax.lax.dynamic_update_slice(arena, inter, (row0, jnp.int32(0)))


@functools.partial(
    jax.jit, donate_argnums=(5, 6), static_argnames=("SL", "STR", "STRC", "TCAP")
)
def _extend_chunk_kernel(
    arena, arena_c, xz_rows, zy_rows, w_slots, table, counts, pair_ids,
    out_base, w_scale, SL: int, STR: int, STRC: int, TCAP: int,
):
    """Consistency-extend one chunk of output pairs, writing packed entries.

    For output pair p and slot s (slot 0 = the base x~y map through the
    identity row; others = one middle sequence z each):
      k = arena[xz_rows[p,s], a];  b = arena[zy_rows[p,s], k];  w = w_slots.
    Per (p, a) the <= SL candidate b's sort (tiny lane-wise sort), duplicate
    b's sum their weights, and each pair's surviving entries pack to the
    front of its fixed STRC*SL table block (see the packing comment below)
    — no host round trip, no dynamic shapes.

    ``arena_c`` is ``arena[:, :STRC]`` (sliced once per chunk class by the
    caller): the composition volume is CP x SL x STRC, so pairs whose left
    sequence is short do not pay the segment-wide stride.  ``STR`` remains
    the full arena row stride for the flat second-hop index.
    """
    CP = xz_rows.shape[0]
    XZ = arena_c[xz_rows].astype(jnp.int32)  # [CP, SL, STRC] row gather
    flat = arena.reshape(-1)
    b = flat[zy_rows[:, :, None] * STR + XZ].astype(jnp.int32)
    b = jnp.where(XZ > 0, b, 0)

    bt = b.transpose(0, 2, 1)  # [CP, STRC, SL]
    wt = jnp.broadcast_to(w_slots[:, None, :], bt.shape)
    DEAD = jnp.int32(1) << 20
    key = jnp.where(bt > 0, bt, DEAD)
    key_s, w_s = jax.lax.sort((key, wt), dimension=2, num_keys=1)
    valid = key_s < DEAD
    first = valid & jnp.concatenate(
        [jnp.ones_like(valid[..., :1]), key_s[..., 1:] != key_s[..., :-1]],
        axis=2,
    )
    # Duplicate-sum along the tiny slot axis (SL <= 32): unrolled masked adds.
    w_live = jnp.where(valid, w_s, 0.0)
    wsum = jnp.zeros_like(w_s)
    for j in range(SL):
        wsum = wsum + jnp.where(
            key_s == key_s[..., j : j + 1], w_live[..., j : j + 1], 0.0
        )

    a_idx = jnp.arange(STRC, dtype=jnp.int32)[None, :, None]
    keep = first & (a_idx > 0)
    M2 = STRC * SL
    N = CP * M2

    # Per-pair kept-first packing, NO cross-pair compaction (a 1D scatter
    # over the N candidates or a searchsorted over their cumsum).  Instead each
    # pair keeps its FIXED STRC*SL block of table rows and one lax.sort per
    # pair row moves kept entries to the block's front in (a, b) order;
    # segment starts are the deterministic block offsets (the caller
    # computes them from the chunk schedule) and segment lengths are the
    # kept counts.  Dead rows sit past each segment's length, never read.
    #
    # Packing is TWO int32 words, NOT one int64: without jax x64 (the
    # default) ``astype(jnp.int64)`` silently truncates
    # to int32, so an ``a << 32`` pack would zero the a-column of EVERY
    # entry — a bug the x64-enabled test suite could never see.
    hi2 = jnp.broadcast_to(a_idx, keep.shape).reshape(CP, M2)
    lo2 = (
        (jnp.where(valid, key_s, 0) << 16)
        | jnp.rint(wsum * w_scale).astype(jnp.int32)
    ).reshape(CP, M2)
    keep2 = keep.reshape(CP, M2)
    idx2 = jax.lax.broadcasted_iota(jnp.int32, (CP, M2), 1)
    sortkey = jnp.where(keep2, idx2, M2 + idx2)  # kept first, stable order
    _, hi_s2, lo_s2 = jax.lax.sort(
        (sortkey, hi2, lo2), dimension=1, num_keys=1
    )
    block = jnp.stack(
        [
            hi_s2.reshape(-1).astype(jnp.uint16),
            (lo_s2.reshape(-1) >> 16).astype(jnp.uint16),
            (lo_s2.reshape(-1) & 0xFFFF).astype(jnp.uint16),
        ],
        axis=1,
    )
    table = jax.lax.dynamic_update_slice(
        table, block, (out_base, jnp.int32(0))
    )
    counts = counts.at[pair_ids].add(keep2.sum(axis=1).astype(jnp.int32))
    return table, counts, out_base + jnp.int32(N)
