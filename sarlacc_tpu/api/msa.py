"""``multi_read_align`` — per-group multiple sequence alignment.

T-Coffee-style progressive MSA with the same structure as the reference's
SeqAn call (src/quick_msa.cpp:25-75, R/multiReadAlign.R:7-48):

1. **Pairwise library** — banded global affine alignments of every pair in
   the group, batched on device (:func:`..ops.msa.banded_pair_align`), each
   decomposed into matched residue pairs weighted by the alignment's percent
   identity (the classic T-Coffee primary library).
2. **Triplet extension** — consistency transform: for every middle sequence
   z, matches x~z and z~y compose into x~y support with weight
   ``min(w_xz, w_zy)``, accumulated onto the direct weights.
3. **Guide tree** — neighbour joining on ``1 - identity`` distances (SeqAn's
   default guide tree for ``globalMsaAlignment``).
4. **Progressive merges** — profile-profile maximal-weighted-trace DP with
   library-sum column scores and zero gap cost, banded, on device
   (:func:`..ops.msa.merge_wave_from_library` — the consistency
   library stays device-resident).

Two deliberate deviations from the reference, both documented:

* the reference's ``max.error`` argument is accepted **and wired**: low
  quality bases are masked to N for alignment and restored afterwards
  (``keep_mask=False``) — the reference documents this behaviour but never
  wired the argument (R/multiReadAlign.R quirk; its unmask kernel
  src/unmask_alignment.cpp is dormant), and its ``groups``-missing branch
  has a fatal typo (``by.groups`` vs ``by.group``) which we simply fix.
* the pairwise band is widened by the length difference of each pair so a
  corner-to-corner path always exists (SeqAn keeps a fixed ±bandwidth).
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..ops.msa import banded_pair_align

#: Longest read the MSA subsystem accepts: positions ride int16 tensors
#: (jmat emission ops/msa.py, the pair-map arena, uint16 library rows), so
#: lengths beyond this would wrap silently.  Margin below 32767 covers the
#: +1 one-past-end conventions.
MAX_MSA_READ_LEN = 32000
from ..refimpl.masking import unmask_alignment
from .umi import quality_mask
from ..utils.profiling import profiled

__all__ = ["multi_read_align"]


def _split_groups(n: int, groups) -> tuple[list[np.ndarray], list | None]:
    if groups is None:
        return [np.arange(n, dtype=np.int64)], None
    if isinstance(groups, (list, tuple)) and (
        len(groups) == 0 or isinstance(groups[0], (list, tuple, np.ndarray))
    ):
        return [np.asarray(g, dtype=np.int64) for g in groups], None
    groups = np.asarray(groups)
    if groups.shape[0] != n:
        raise ValueError("length of 'reads' and 'groups' should be the same")
    keys = np.unique(groups)
    return [np.flatnonzero(groups == k).astype(np.int64) for k in keys], [
        str(k) for k in keys
    ]


def _pair_libraries(codes, lengths, by_group, match, mismatch, go, ge, bandwidth):
    """All-pairs alignments for ALL groups in one batched device launch.

    Returns per-group (lib, ident) lists, where lib[(x, y)] = (pa, pb, w)
    arrays for x < y (local indices) and ident[x, y] = fractional identity.
    """
    jobs: list[tuple[int, int, int]] = []  # (group #, local x, local y)
    for gi, idx in enumerate(by_group):
        g = idx.size
        xs, ys = np.triu_indices(g, k=1)
        jobs.extend((gi, int(x), int(y)) for x, y in zip(xs, ys))

    libs = [dict() for _ in by_group]
    idents = [np.ones((idx.size, idx.size)) for idx in by_group]
    if not jobs:
        return libs, idents

    ga = np.asarray([by_group[g][x] for g, x, y in jobs])
    gb = np.asarray([by_group[g][y] for g, x, y in jobs])
    scores, paths = banded_pair_align(
        codes[ga], lengths[ga], codes[gb], lengths[gb],
        match, mismatch, go, ge, bandwidth,
    )
    from ..utils.profiling import profiler as _prof
    with _prof("msa.pair_postprocess"):
        return _pair_post(jobs, paths, codes, ga, gb, libs, idents)


def _pair_post(jobs, paths, codes, ga, gb, libs, idents):
    for p, (gi, x, y) in enumerate(jobs):
        pa, pb = paths[p]
        if pa.size:
            eq = codes[ga[p]][pa - 1] == codes[gb[p]][pb - 1]
            frac = float(eq.sum()) / pa.size
        else:
            frac = 0.0
        w = np.full(pa.size, frac * 100.0, dtype=np.float32)
        libs[gi][(x, y)] = (pa, pb, w)
        idents[gi][x, y] = idents[gi][y, x] = frac
    return libs, idents


def _get_lib(lib, x, y):
    """(positions-of-x, positions-of-y, weights) regardless of stored order."""
    if x < y:
        return lib.get((x, y), None)
    entry = lib.get((y, x), None)
    if entry is None:
        return None
    pa, pb, w = entry
    return pb, pa, w


def _triplet_extension(lib, g, lengths_local):
    """One round of T-Coffee consistency extension (min-weight composition).

    Uses the native C++ path when available (sarlacc_tpu.native); this
    Python implementation is the fallback and the parity oracle.
    """
    from ..native import triplet_extend_native

    native = triplet_extend_native(int(g), lib)
    if native is not None:
        return native

    extra: dict[tuple[int, int], list] = {}
    for z in range(g):
        for x in range(g):
            if x == z:
                continue
            ex = _get_lib(lib, x, z)
            if ex is None or ex[0].size == 0:
                continue
            for y in range(x + 1, g):
                if y == z:
                    continue
                ey = _get_lib(lib, z, y)
                if ey is None or ey[0].size == 0:
                    continue
                # join on z positions (both monotone & unique).
                common, i1, i2 = np.intersect1d(
                    ex[1], ey[0], assume_unique=True, return_indices=True
                )
                if common.size == 0:
                    continue
                w = np.minimum(ex[2][i1], ey[2][i2])
                extra.setdefault((x, y), []).append((ex[0][i1], ey[1][i2], w))

    merged: dict[tuple[int, int], tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for x in range(g):
        for y in range(x + 1, g):
            parts = []
            base = lib.get((x, y))
            if base is not None and base[0].size:
                parts.append(base)
            parts.extend(extra.get((x, y), []))
            if not parts:
                continue
            pa = np.concatenate([p[0] for p in parts])
            pb = np.concatenate([p[1] for p in parts])
            w = np.concatenate([p[2] for p in parts])
            key = pa.astype(np.int64) * (int(lengths_local[y]) + 1) + pb
            uniq, inv = np.unique(key, return_inverse=True)
            wsum = np.zeros(uniq.size, dtype=np.float64)
            np.add.at(wsum, inv, w)
            merged[(x, y)] = (
                (uniq // (int(lengths_local[y]) + 1)).astype(np.int32),
                (uniq % (int(lengths_local[y]) + 1)).astype(np.int32),
                wsum.astype(np.float32),
            )
    return merged


def _nj_tree(dist: np.ndarray) -> list[tuple[int, int]]:
    """Neighbour-joining merge order; returns [(node_a, node_b), ...] where
    leaves are 0..g-1 and internal nodes get indices g, g+1, ...
    """
    g = dist.shape[0]
    if g == 1:
        return []
    active = list(range(g))
    d = dist.astype(np.float64).copy()
    nodes = {i: i for i in range(g)}
    merges: list[tuple[int, int]] = []
    nxt = g
    while len(active) > 2:
        n = len(active)
        sub = d[np.ix_(active, active)]
        r = sub.sum(axis=1)
        q = (n - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        a, b = np.unravel_index(np.argmin(q), q.shape)
        if a > b:
            a, b = b, a
        ia, ib = active[a], active[b]
        merges.append((nodes[ia], nodes[ib]))
        # distances to the new node.
        dnew = 0.5 * (d[ia, :] + d[ib, :] - d[ia, ib])
        d = np.pad(d, ((0, 1), (0, 1)))
        d[-1, : d.shape[1] - 1] = dnew
        d[: d.shape[0] - 1, -1] = dnew
        inew = d.shape[0] - 1
        nodes[inew] = nxt
        nxt += 1
        active = [v for v in active if v not in (ia, ib)] + [inew]
    if len(active) == 2:
        merges.append((nodes[active[0]], nodes[active[1]]))
    return merges


class _Profile:
    """members: local sequence indices; c2p[m, c] = 1-based seq position
    or 0 for gap, for member m at column c ([nmembers, ncols] int32)."""

    def __init__(self, members: list[int], c2p: np.ndarray):
        self.members = members
        self.c2p = c2p

    @property
    def ncols(self) -> int:
        return self.c2p.shape[1]

    @classmethod
    def leaf(cls, m: int, length: int) -> "_Profile":
        return cls([m], np.arange(1, length + 1, dtype=np.int32)[None, :])


def _merge_columns(la: int, lb: int, ai, bi):
    """Merged column layout for matched pairs (ai, bi) (1-based ascending).

    Returns (acol, bcol): for each merged column, the source column in A/B
    (1-based) or 0 for a gap.  Vectorized equivalent of the reference merge
    walk (a-gap run, then b-gap run, then the match — quick_msa's progressive
    column interleaving): match t lands at ai[t]+bi[t]-t-2; an unmatched
    a-column ca after m matches lands at ca-1-m+bi[m-1]; an unmatched
    b-column cb before match m lands at ai[m]-1-m+cb-1 (trailing run uses
    ai[M] = la+1).
    """
    ai = np.asarray(ai, dtype=np.int64)
    bi = np.asarray(bi, dtype=np.int64)
    M = ai.size
    ncols = la + lb - M
    acol = np.zeros(ncols, dtype=np.int32)
    bcol = np.zeros(ncols, dtype=np.int32)
    if M:
        mpos = ai + bi - np.arange(M) - 2
        acol[mpos] = ai
        bcol[mpos] = bi
    a_hit = np.zeros(la + 1, dtype=bool)
    a_hit[ai] = True
    ua = np.flatnonzero(~a_hit[1:]).astype(np.int64) + 1
    if ua.size:
        m = np.searchsorted(ai, ua)
        bprev = np.concatenate([[0], bi])[m]
        acol[ua - 1 - m + bprev] = ua
    b_hit = np.zeros(lb + 1, dtype=bool)
    b_hit[bi] = True
    ub = np.flatnonzero(~b_hit[1:]).astype(np.int64) + 1
    if ub.size:
        m = np.searchsorted(bi, ub)
        anext = np.concatenate([ai, [la + 1]])[m]
        bcol[anext - 1 - m + ub - 1] = ub
    return acol, bcol


def _apply_merge(pa: _Profile, pb: _Profile, ai, bi) -> _Profile:
    acol, bcol = _merge_columns(pa.ncols, pb.ncols, ai, bi)
    za = np.zeros((pa.c2p.shape[0], 1), dtype=np.int32)
    zb = np.zeros((pb.c2p.shape[0], 1), dtype=np.int32)
    new_c2p = np.concatenate(
        [
            np.concatenate([za, pa.c2p], axis=1)[:, acol],
            np.concatenate([zb, pb.c2p], axis=1)[:, bcol],
        ],
        axis=0,
    )
    return _Profile(pa.members + pb.members, new_c2p)


def _merge_descriptor(gi, pa: _Profile, pb: _Profile, pair_seg, bandwidth: int):
    """Wave-input descriptor for one profile merge (see merge_wave_from_library)."""
    la, lb = pa.ncols, pb.ncols
    diff = lb - la
    lo = min(0, diff) - bandwidth
    hi = max(0, diff) + bandwidth

    def flat_maps(prof: _Profile):
        """Inverse (position -> column) maps for every member, flattened.

        One scatter builds all members' maps: member rows are disjoint
        windows of the flat array, and positions within a member are unique.
        """
        c2p = prof.c2p
        nm, nc = c2p.shape
        if nm == 0:
            return np.zeros(1, np.int32), []
        sizes = c2p.max(axis=1, initial=0).astype(np.int64) + 1
        offs64 = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        flat = np.zeros(int(sizes.sum()), np.int32)
        nz = c2p > 0
        idx = (offs64[:, None] + c2p)[nz]
        cols = np.broadcast_to(np.arange(1, nc + 1, dtype=np.int32), c2p.shape)
        flat[idx] = cols[nz]
        return flat, [int(o) for o in offs64]

    p2ca, aoffs = flat_maps(pa)
    p2cb, boffs = flat_maps(pb)

    segments = []
    for mi, a in enumerate(pa.members):
        for mj, b in enumerate(pb.members):
            if a < b:
                key, swap = (gi, a, b), 0
            else:
                key, swap = (gi, b, a), 1
            seg = pair_seg.get(key)
            if seg is None or seg[1] == 0:
                continue
            segments.append((seg[0], seg[1], aoffs[mi], boffs[mj], swap))
    return {
        "la": la,
        "lb": lb,
        "lo": lo,
        "kmax": hi - lo,
        "segments": segments,
        "p2ca": p2ca,
        "p2cb": p2cb,
    }


def _run_merge_wave(lib_dev, wave, descs):
    """Run one wave of merges: dispatch every shape class, then read back.

    Shape classes keep the sequential DP scan short for small merges (rows
    is a scan axis — padding costs latency, not just FLOPs), while the
    dispatch/collect split queues all classes on device before any
    readback.
    """
    import jax.numpy as jnp

    from ..ops.msa import _pack_jmat_kernel, merge_wave_from_library

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    # Class by ROWS only: rows is the sequential scan axis (padding it costs
    # latency), while width only pads the per-step vector work, which is
    # latency-dominated anyway — so merges of different widths share a
    # launch at the widest bucket.
    def _bkt2(x, base):
        """Coarse bucket with TWO sizes per octave (pow2 and 1.5*pow2).

        The pack kernel's T is a static jit arg; bucketing it at 64K
        granularity minted a NEW executable almost every wave (the row sum
        varies continuously), and every executable costs a compile and
        stays resident in host memory.  Two sizes per octave caps padding
        at 33% while keeping the executable count logarithmic.
        """
        b = base
        while True:
            if x <= b:
                return b
            if x <= b + b // 2:
                return b + b // 2
            b *= 2

    classes: dict = {}
    for i, d in enumerate(descs):
        classes.setdefault(_bkt(max(d["la"], 1), 64), []).append(i)
    inflight = []
    from ..utils.profiling import profiler

    for rb, idxs in classes.items():
        wb = _bkt(max(descs[i]["kmax"] + 1 for i in idxs), 64)
        jmat_dev = merge_wave_from_library(lib_dev, [descs[i] for i in idxs], rb, wb)
        # Pack exact per-merge row runs on device: only the real path rows
        # are read back (the padded [rows_b, Pp] plane is ~3x larger).
        las = np.asarray([descs[i]["la"] for i in idxs], np.int64)
        starts = np.zeros(las.size + 1, np.int32)
        np.cumsum(las, out=starts[1:])
        total = int(starts[-1])
        Tb = _bkt2(max(total, 1), 1 << 16)
        # starts/cols SHAPES are jit avals too: pad to a pow2 merge count
        # (padded segments start at `total` and map to column 0; the caller
        # never reads flat rows >= total) so the executable count stays
        # logarithmic instead of one per wave.
        Sb = _bkt(max(las.size, 1), 64)
        starts_p = np.full(Sb + 1, total, np.int32)
        starts_p[: las.size + 1] = starts
        cols_p = np.zeros(Sb, np.int32)
        cols_p[: las.size] = np.arange(las.size, dtype=np.int32)
        with profiler("msa.merge_pack"):
            flat_dev = _pack_jmat_kernel(
                jmat_dev, jnp.asarray(starts_p), jnp.asarray(cols_p), T=Tb
            )
        inflight.append((idxs, las, starts, flat_dev))
    from ..utils.profiling import profiler

    paths: list = [None] * len(descs)
    with profiler("msa.merge_readback"):
        for idxs, las, starts, flat_dev in inflight:
            flat = np.asarray(flat_dev)
            for k, i in enumerate(idxs):
                seg = flat[starts[k] : starts[k] + las[k]]
                rr = np.flatnonzero(seg)
                paths[i] = ((rr + 1).astype(np.int32), seg[rr].astype(np.int32))
    return paths


def _lib_w_scale(by_group, active) -> float:
    """uint16 fixed-point scale for library weights.

    An extended entry's weight is bounded a priori by 100*(g-1) (base + one
    min-composition per middle sequence, each <= 100), so one global scale
    is exact to ~wbound/65535 — far below the f32 tie-break noise the
    pipeline already tolerates.
    """
    gmax = max((by_group[gi].size for gi in active), default=2)
    return 65535.0 / (100.0 * max(gmax - 1, 1) + 1.0)


def _device_lib_ok(
    lengths, by_group, active, budget_bytes: int | None = None
) -> bool:
    """Size guard for the device library path.

    The extension kernel's unrolled duplicate-sum is O(SL^2) and assumes
    SL <= 32 slots (SL = bucketed g-1), and the packed entry table grows as
    O(#pairs * SL * stride); groups too large for either must take the host
    path automatically, not only via SARLACC_HOST_LIB.
    """

    if budget_bytes is None:
        from ..utils.membudget import device_memory_budget

        # ~1/8 of free device memory leaves headroom for the arena, cost
        # planes, and merge-wave intermediates.  The fraction was chosen on
        # earlier hardware and has not yet been measured on the GPU.
        budget_bytes = device_memory_budget("lib_table", 0.125, 1 << 31)

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    sl_max = 1
    npairs_sl = 0  # sum over pairs of their slot bucket
    for gi in active:
        g = by_group[gi].size
        sl = _bkt(max(g - 1, 1), 2)
        sl_max = max(sl_max, sl)
        npairs_sl += (g * (g - 1) // 2) * sl
    if sl_max > 32:
        return False
    lmax = int(lengths[np.concatenate([by_group[gi] for gi in active])].max(initial=1)) if active else 1
    stride = _bkt(lmax + 1, 128)
    # table rows are uint16[3]; chunks pad to CP pairs but the pair-sum
    # estimate dominates.
    return npairs_sl * stride * 6 <= budget_bytes


def _build_library_device(
    codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth
):
    """Extended T-Coffee library built entirely on device.

    The pair walks' jmats stay on device as dense position maps; the
    consistency extension composes them with gathers and tiny lane-wise
    sorts (:func:`..ops.msa._extend_chunk_kernel`), writing the packed
    [T, 3] entry table in place.  Only per-pair identities and entry counts
    ever cross the link — the extended library (the framework's largest
    tensor) never transfers.

    Returns (lib_dev = (table, w_inv), pair_seg, idents-per-active-group).
    """
    import jax
    import jax.numpy as jnp

    from ..ops.msa import (
        ARENA_IDENT_ROW,
        _extend_chunk_kernel,
        pair_maps_device,
    )
    from ..utils.profiling import profiler

    jobs: list[tuple[int, int, int]] = []
    jobid: dict[tuple[int, int, int], int] = {}
    for pos, gi in enumerate(active):
        g = by_group[gi].size
        xs, ys = np.triu_indices(g, k=1)
        for x, y in zip(xs, ys):
            jobid[(gi, int(x), int(y))] = len(jobs)
            jobs.append((gi, int(x), int(y)))

    w_scale = _lib_w_scale(by_group, active)
    idents = [np.ones((by_group[gi].size, by_group[gi].size)) for gi in active]
    if not jobs:
        lib_dev = (jnp.zeros((1, 3), jnp.uint16), np.float32(1.0 / w_scale))
        return lib_dev, {}, idents

    ga = np.asarray([by_group[g][x] for g, x, y in jobs])
    gb = np.asarray([by_group[g][y] for g, x, y in jobs])
    with profiler("msa.pair_library"):
        arena, stride, fracs, arow = pair_maps_device(
            codes, lengths, ga, gb, match, mismatch, go, ge, bandwidth,
        )
    gi_of_active = {gi: pos for pos, gi in enumerate(active)}
    for i, (gi, x, y) in enumerate(jobs):
        pos = gi_of_active[gi]
        idents[pos][x, y] = idents[pos][y, x] = fracs[i]

    def dir_row(gi, u, v):
        """Arena row holding the u -> v position map (dispatch-order
        slabs — see pair_maps_device's contiguous-placement pre-pass)."""
        if u < v:
            return int(arow[jobid[(gi, u, v)]])
        return int(arow[jobid[(gi, v, u)]]) + 1

    # Chunk output pairs by slot-count class (SL = bucketed g-1: the base
    # slot plus one per middle sequence).
    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    # Chunk classes by (slot bucket, x-length bucket): the composition,
    # dedup-sort and compaction all scale with CP x SL x STRC, so pairs
    # whose left sequence is short must not pay the segment-wide stride,
    # and the slot ladder is finer than pow2 (g-1 = 10, the modal UMI
    # family size, would waste 37% of every launch at SL = 16).
    _SL_LADDER = (2, 4, 6, 8, 10, 12, 16, 20, 24, 32)

    def _sl_class(v: int) -> int:
        for s in _SL_LADDER:
            if v <= s:
                return s
        return _SL_LADDER[-1]

    classes: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
    for pos, gi in enumerate(active):
        g = by_group[gi].size
        sl = _sl_class(max(g - 1, 1))
        for x, y in zip(*np.triu_indices(g, k=1)):
            strc = min(
                _bkt(int(lengths[by_group[gi][x]]) + 1, 128), stride
            )
            classes.setdefault((sl, strc), []).append((gi, int(x), int(y)))

    # Pairs per launch: bounds the [CP, STRC, SL] intermediates (~50 MB at
    # CP=1024, SL=12, STRC=1024) while keeping launches few.
    CP = 1024
    t_cap = sum(
        ((len(prs) + CP - 1) // CP) * CP * sl * strc
        for (sl, strc), prs in classes.items()
    )
    t_cap = _bkt(max(t_cap, 1), 1 << 16)  # pow2: one compile per size class
    ncnt = _bkt(len(jobs) + 1, 1024)
    with profiler("msa.triplet"):
        table = jnp.zeros((t_cap, 3), jnp.uint16)
        counts = jnp.zeros(ncnt, jnp.int32)
        out_base = jnp.int32(0)
        # Each pair owns a fixed STRC*SL block of table rows (the extension
        # kernel packs kept entries to the block front); starts follow the
        # chunk schedule deterministically, lengths come from counts.
        seg_start: dict[tuple[int, int, int], int] = {}
        base_at = 0
        arena_c: dict[int, object] = {stride: arena}
        for sl, strc in sorted(classes):
            prs = classes[(sl, strc)]
            if strc not in arena_c:
                arena_c[strc] = arena[:, :strc]
            for c0 in range(0, len(prs), CP):
                chunk = prs[c0 : c0 + CP]
                for r, key in enumerate(chunk):
                    seg_start[key] = base_at + r * strc * sl
                base_at += CP * strc * sl
                xz = np.zeros((CP, sl), np.int32)
                zy = np.zeros((CP, sl), np.int32)
                ws = np.zeros((CP, sl), np.float32)
                pid = np.full(CP, len(jobs), np.int32)
                for r, (gi, x, y) in enumerate(chunk):
                    pos = gi_of_active[gi]
                    g = by_group[gi].size
                    pid[r] = jobid[(gi, x, y)]
                    xz[r, 0] = dir_row(gi, x, y)
                    zy[r, 0] = ARENA_IDENT_ROW
                    ws[r, 0] = idents[pos][x, y] * 100.0
                    s = 1
                    for z in range(g):
                        if z == x or z == y:
                            continue
                        xz[r, s] = dir_row(gi, x, z)
                        zy[r, s] = dir_row(gi, z, y)
                        ws[r, s] = min(idents[pos][x, z], idents[pos][z, y]) * 100.0
                        s += 1
                # numpy args go straight into the jitted call: each eager
                # jnp.asarray would be a dispatch of its own.
                table, counts, out_base = _extend_chunk_kernel(
                    arena, arena_c[strc], xz, zy, ws,
                    table, counts, pid, out_base,
                    np.float32(w_scale), SL=sl, STR=stride, STRC=strc,
                    TCAP=t_cap,
                )
        counts_np = np.asarray(counts).astype(np.int64)

    pair_seg: dict = {}
    for key, start in seg_start.items():
        pair_seg[key] = (start, int(counts_np[jobid[key]]))
    lib_dev = (table, np.float32(1.0 / w_scale))
    return lib_dev, pair_seg, idents


def _build_library_host(
    codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth
):
    """Host-path library (C++/NumPy triplet extension + packed upload).

    Kept as the debuggable fallback and the parity anchor for the device
    path (SARLACC_HOST_LIB=1 selects it).
    """
    import jax
    import jax.numpy as jnp

    from ..utils.profiling import profiler

    with profiler("msa.pair_library"):
        libs, idents = _pair_libraries(
            codes, lengths, [by_group[gi] for gi in active],
            match, mismatch, go, ge, bandwidth,
        )

    pair_seg: dict = {}
    w_scale = _lib_w_scale(by_group, active)

    # Triplet extension per group in a thread pool (the C++ call releases
    # the GIL, so groups extend concurrently).  The main thread consumes
    # results in order and starts each group's device upload immediately —
    # device_put is async, so the transfers overlap the remaining groups'
    # extensions.
    with profiler("msa.triplet"):
        from concurrent.futures import ThreadPoolExecutor

        def _extend_and_pack(pos):
            lib = _triplet_extension(
                libs[pos], by_group[active[pos]].size,
                lengths[by_group[active[pos]]],
            )
            keys = sorted(lib)
            sizes = [lib[k][0].size for k in keys]
            n = int(sum(sizes))
            tab = np.zeros((n, 3), np.uint16)  # one row gather per entry
            if n:
                tab[:, 0] = np.concatenate([lib[k][0] for k in keys])
                tab[:, 1] = np.concatenate([lib[k][1] for k in keys])
                tab[:, 2] = np.rint(
                    np.concatenate([lib[k][2] for k in keys]) * w_scale
                )
            return keys, sizes, tab

        dev_parts = []
        lib_at = 0
        with ThreadPoolExecutor(max_workers=8) as pool:
            for pos, (keys, sizes, tab) in enumerate(
                pool.map(_extend_and_pack, range(len(active)))
            ):
                gi = active[pos]
                if tab.size:
                    dev_parts.append(jax.device_put(tab))
                for k, sz in zip(keys, sizes):
                    pair_seg[(gi, k[0], k[1])] = (lib_at, sz)
                    lib_at += sz

    with profiler("msa.lib_upload"):
        if dev_parts:
            lib_tab = jnp.concatenate(dev_parts) if len(dev_parts) > 1 else dev_parts[0]
        else:
            lib_tab = jnp.zeros((1, 3), jnp.uint16)
        # pow2-pad the table: its aval feeds every wave's accumulate kernel,
        # and an exact size would recompile that kernel per segment.
        cap = 1 << 16
        while cap < lib_tab.shape[0]:
            cap *= 2
        if cap != lib_tab.shape[0]:
            lib_tab = jnp.concatenate(
                [lib_tab, jnp.zeros((cap - lib_tab.shape[0], 3), jnp.uint16)]
            )
        lib_dev = (lib_tab, np.float32(1.0 / w_scale))
        jax.block_until_ready(lib_tab)
    return lib_dev, pair_seg, idents


def _segment_lib_budget() -> int:
    """Estimated-library byte budget per MSA segment: ~1/16 of free device
    memory keeps segments under the device-path table guard and bounds
    peak device memory.

    Segment count scales inversely with this budget, and every segment
    pays fixed costs (library upload, extension chunk ladder, its own
    merge waves), while merge-wave cost grows superlinearly with groups
    per segment — wider waves pad every group to the wave's widest merge
    and rebuild larger cost planes.  The fraction was chosen on earlier
    hardware and has not yet been measured on the GPU;
    ``SARLACC_MSA_SEG_BUDGET_GB`` (float, GiB) overrides it."""
    import os

    from ..utils.membudget import device_memory_budget

    env = os.environ.get("SARLACC_MSA_SEG_BUDGET_GB")
    if env:
        return max(int(float(env) * (1 << 30)), 64 << 20)
    return device_memory_budget("lib_segment", 1 / 16, 1 << 30)


def _group_lib_bytes(lengths, idx) -> int:
    """Estimated packed extended-library bytes for one group ([T, 3] uint16
    rows ~ pairs * slot-bucket * stride)."""

    def _bkt(x, base):
        b = base
        while b < x:
            b *= 2
        return b

    g = idx.size
    if g < 2:
        return 0
    sl = _bkt(max(g - 1, 1), 2)
    stride = _bkt(int(lengths[idx].max(initial=1)) + 1, 128)
    return (g * (g - 1) // 2) * sl * stride * 6


def _msa_groups(codes, lengths, by_group, match, mismatch, go, ge, bandwidth):
    """MSA for all groups, batching device launches across groups.

    Groups are packed into **segments** whose estimated consistency-library
    size fits :func:`_segment_lib_budget`; each segment builds its library
    in one batched launch set and runs its merges in cross-group waves.
    Segmenting bounds peak device memory (the library of an unsegmented
    large workload grows without bound) while keeping launches thousands of
    pairs wide.
    """
    decode = np.frombuffer(b"ACGTN-", dtype=np.uint8)
    results: list[list[str] | None] = [None] * len(by_group)

    active: list[int] = []
    for gi, idx in enumerate(by_group):
        g = idx.size
        if g == 0:
            results[gi] = []
        elif g == 1:
            n = int(lengths[idx[0]])
            results[gi] = [decode[codes[idx[0], :n]].tobytes().decode()]
        else:
            active.append(gi)

    # Groups too wide for the device extension kernel (slot bucket > 32,
    # see _device_lib_ok) segment separately: one oversized group must not
    # drag its whole segment onto the host path.
    seg_budget = _segment_lib_budget()
    segments: list[list[int]] = []
    for eligible in (True, False):
        cur: list[int] = []
        cur_bytes = 0
        for gi in active:
            g = by_group[gi].size
            sl = 2
            while sl < max(g - 1, 1):
                sl *= 2
            if (sl <= 32) != eligible:
                continue
            b = _group_lib_bytes(lengths, by_group[gi])
            if cur and cur_bytes + b > seg_budget:
                segments.append(cur)
                cur, cur_bytes = [], 0
            cur.append(gi)
            cur_bytes += b
        if cur:
            segments.append(cur)

    for seg in segments:
        _msa_segment(
            codes, lengths, by_group, seg, match, mismatch, go, ge,
            bandwidth, decode, results,
        )
    return results


def _msa_segment(
    codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth,
    decode, results,
):
    """Library + guide trees + merge waves for one segment of groups."""
    from ..utils.profiling import profiler

    import os

    if os.environ.get("SARLACC_HOST_LIB") or not _device_lib_ok(
        lengths, by_group, active
    ):
        lib_dev, pair_seg, idents = _build_library_host(
            codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth
        )
    else:
        lib_dev, pair_seg, idents = _build_library_device(
            codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth
        )

    state = {}
    with profiler("msa.guide_tree"):
        for pos, gi in enumerate(active):
            idx = by_group[gi]
            g = idx.size
            merges = _nj_tree(1.0 - idents[pos])
            lens_local = lengths[idx]
            profiles = {
                m: _Profile.leaf(m, int(lens_local[m])) for m in range(g)
            }
            state[gi] = {"merges": merges, "profiles": profiles, "nxt": g}

    # Readiness-scheduled waves: each wave batches EVERY merge (across all
    # groups) whose operand profiles both exist — disjoint subtrees of one
    # guide tree merge concurrently, so the number of waves is the deepest
    # tree depth, not the merge count.
    for gi in active:
        st = state[gi]
        st["node_of_merge"] = {
            k: st["nxt"] + k for k in range(len(st["merges"]))
        }
        st["todo"] = list(range(len(st["merges"])))

    pending = [gi for gi in active if state[gi]["todo"]]
    while pending:
        wave, descs = [], []
        trivial = []  # merges with an empty side need no DP
        for gi in pending:
            st = state[gi]
            for k in list(st["todo"]):
                a, b = st["merges"][k]
                if a not in st["profiles"] or b not in st["profiles"]:
                    continue
                pa, pb = st["profiles"][a], st["profiles"][b]
                if pa.ncols == 0 or pb.ncols == 0:
                    trivial.append((gi, k, a, b))
                else:
                    with profiler("msa.merge_cost"):
                        descs.append(
                            _merge_descriptor(gi, pa, pb, pair_seg, bandwidth)
                        )
                    wave.append((gi, k, a, b))

        with profiler("msa.merge_kernel"):
            paths = _run_merge_wave(lib_dev, wave, descs)
        with profiler("msa.apply_merge"):
            for (gi, k, a, b), (ai, bi) in zip(wave, paths):
                st = state[gi]
                st["profiles"][st["node_of_merge"][k]] = _apply_merge(
                    st["profiles"][a], st["profiles"][b], ai, bi
                )
                del st["profiles"][a], st["profiles"][b]
                st["todo"].remove(k)
        for gi, k, a, b in trivial:
            st = state[gi]
            pa, pb = st["profiles"][a], st["profiles"][b]
            if pa.ncols == 0:
                merged = _Profile(
                    pa.members + pb.members,
                    np.concatenate(
                        [np.zeros((len(pa.members), pb.ncols), np.int32), pb.c2p]
                    ),
                )
            else:
                merged = _Profile(
                    pa.members + pb.members,
                    np.concatenate(
                        [pa.c2p, np.zeros((len(pb.members), pa.ncols), np.int32)]
                    ),
                )
            st["profiles"][st["node_of_merge"][k]] = merged
            del st["profiles"][a], st["profiles"][b]
            st["todo"].remove(k)
        pending = [gi for gi in pending if state[gi]["todo"]]

    with profiler("msa.reconstruct"):
        _reconstruct(state, active, by_group, codes, decode, results)


def _reconstruct(state, active, by_group, codes, decode, results):
    for gi in active:
        st = state[gi]
        idx = by_group[gi]
        g = idx.size
        final_id = (
            st["node_of_merge"][len(st["merges"]) - 1]
            if st["merges"]
            else 0
        )
        final = st["profiles"][final_id]
        inv = np.empty(g, np.int64)
        inv[np.asarray(final.members)] = np.arange(g)
        c2p = final.c2p[inv]  # [g, ncols] in member order
        seqs = codes[idx]  # [g, L]
        rows = np.full(c2p.shape, 5, dtype=np.int8)
        nz = c2p > 0
        rows[nz] = seqs[np.nonzero(nz)[0], (c2p - 1)[nz]]
        chars = decode[rows]
        results[gi] = [chars[m].tobytes().decode() for m in range(g)]
    return results


@profiled("multi_read_align")
def multi_read_align(
    reads: SeqBatch,
    groups=None,
    max_error: float | None = None,
    match: float = 0,
    mismatch: float = -1,
    gap_opening: float = 5,
    gap_extension: float = 1,
    bandwidth: int = 100,
    keep_mask: bool = False,
    qual_type: str = "phred",
    mesh=None,
) -> Frame:
    """MSA per read group; returns Frame(alignments=List, qualities=List).

    ``mesh`` (BPPARAM analog, R/multiReadAlign.R:7) shards the pairwise
    library construction — the DP-heavy stage — over devices; the merge
    waves and host orchestration are unchanged, so results are identical to
    the single-device run.
    """
    n = len(reads)
    by_group, names = _split_groups(n, groups)

    # The device walk and position arenas store read coordinates as int16
    # (halves their device footprint and readbacks); the reference
    # accepts arbitrary lengths (src/DNA_input.cpp:106-116), so guard the
    # boundary explicitly rather than wrapping silently on >32 kb reads.
    max_len = int(reads.lengths.max(initial=0))
    if max_len > MAX_MSA_READ_LEN:
        raise ValueError(
            f"multi_read_align supports reads up to {MAX_MSA_READ_LEN} bases "
            f"(got {max_len}); split longer reads or raise the int32 path"
        )

    use_mask = max_error is not None and not (
        isinstance(max_error, float) and np.isnan(max_error)
    )
    if use_mask:
        masked = quality_mask(reads, max_error, qual_type)
        codes = masked.codes
    else:
        codes = reads.codes
    lengths = reads.lengths

    from ..parallel.context import use_mesh

    with use_mesh(mesh):
        alignments = _msa_groups(
            codes,
            lengths,
            by_group,
            float(match),
            float(mismatch),
            float(gap_opening),
            float(gap_extension),
            int(bandwidth),
        )
    if use_mask and not keep_mask:
        dec = np.frombuffer(b"ACGTN-", dtype=np.uint8)
        for gi, idx in enumerate(by_group):
            if not alignments[gi]:
                continue
            orig_strs = [
                dec[reads.codes[i, : int(lengths[i])]].tobytes().decode()
                for i in idx
            ]
            alignments[gi] = unmask_alignment(alignments[gi], orig_strs)

    out = Frame(nrow=len(by_group))
    out["alignments"] = alignments
    if reads.quals is not None:
        qstrs = reads.qual_strings()
        out["qualities"] = [[qstrs[int(i)] for i in idx] for idx in by_group]
    if names is not None:
        out.rownames = names
    return out
