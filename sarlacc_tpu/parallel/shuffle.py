"""Shuffle-by-pregroup: co-locate each UMI pre-group on one shard.

At pod scale the reads of one pre-group (the reference's ``split()`` factor,
R/umiGroup.R:13-19) can land on different data-parallel shards after the
streaming/alignment stages.  Grouping and MSA are per-pre-group algorithms,
so before them every pre-group must live wholly on one shard (SURVEY.md
§5.8(iii)).  This module provides that regroup-by-key:

* :func:`assign_pregroups` — deterministic longest-processing-time bin
  packing of pre-groups onto shards (largest group first, ties to the lower
  original index; least-loaded shard, ties to the lower shard id).  Pure
  host metadata — group *sizes* only.
* :func:`shuffle_by_pregroup` — builds the read permutation that realizes
  the assignment and reshards batch-major arrays so shard ``s`` holds
  exactly its groups' reads (padded to the common per-shard budget).  When
  the inputs are device arrays sharded over the mesh this ``device_put`` is
  an all-to-all resharding between devices; from host memory it is a scatter of
  each shard's slice.
* :func:`sharded_umi_group` — the distributed ``umi_group``: per-shard
  neighbour search + greedy clustering over the shard's own pre-groups,
  results merged back in the original pre-group order so the output is
  *identical* to the single-device run (asserted by
  tests/test_shuffle.py and the driver's ``dryrun_multichip``).

The reference analog of all of this is BiocParallel's contiguous sharder
(R/adaptorAlign.R:126-134) plus the driver-side list concatenation; here the
sharder is group-size-aware and the "concatenation" is a deterministic
merge-by-original-order.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "assign_pregroups",
    "shuffle_by_pregroup",
    "sharded_umi_group",
    "sharded_pregroup_msa",
]


def assign_pregroups(sizes, n_shards: int) -> np.ndarray:
    """Deterministic LPT assignment: shard id per pre-group.

    Work per group is dominated by the O(g^2) neighbour search, so the load
    measure is ``size**2``; the order (largest first, ties by index; least
    loaded shard, ties by id) is fully deterministic, making multi-host runs
    reproducible and equal to the single-host result.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    order = np.lexsort((np.arange(sizes.size), -sizes))
    load = np.zeros(n_shards, dtype=np.float64)
    shard_of = np.zeros(sizes.size, dtype=np.int32)
    for gi in order:
        s = int(np.argmin(load))  # argmin takes the first (lowest id) tie
        shard_of[gi] = s
        load[s] += float(sizes[gi]) ** 2 + 1.0
    return shard_of


def _plan(by_group, n_shards: int):
    """(perm, shard_slices, local_groups) realizing the LPT assignment.

    ``perm`` lists global read indices ordered by (shard, original group
    order, original within-group order); ``local_groups[s]`` maps each of
    shard s's pre-groups to (original group index, local index array into
    the shard's slice).
    """
    sizes = [g.size for g in by_group]
    shard_of = assign_pregroups(sizes, n_shards)
    perm_parts: list[np.ndarray] = []
    local_groups: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n_shards)]
    counts = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        at = 0
        for gi, g in enumerate(by_group):
            if shard_of[gi] != s:
                continue
            perm_parts.append(np.asarray(g, dtype=np.int64))
            local_groups[s].append(
                (gi, np.arange(at, at + g.size, dtype=np.int64))
            )
            at += g.size
        counts[s] = at
    perm = (
        np.concatenate(perm_parts)
        if perm_parts
        else np.zeros(0, dtype=np.int64)
    )
    return perm, counts, local_groups


def shuffle_by_pregroup(mesh, by_group, *arrays):
    """Reshard batch-major ``arrays`` so each pre-group lands on one shard.

    Returns ``(sharded_arrays, local_groups)`` where ``sharded_arrays[k]``
    has shape ``[S * budget, ...]`` sharded over the mesh's first axis
    (shard s owns rows ``[s*budget, (s+1)*budget)``) and ``local_groups[s]``
    is the shard's pre-group structure from :func:`_plan` (indices relative
    to the shard's row block).  Padding rows repeat row 0 (never addressed:
    every local index is < the shard's real count).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    perm, counts, local_groups = _plan(by_group, n_shards)
    budget = max(int(counts.max(initial=0)), 1)

    # Global gather order with per-shard padding (pad rows reuse index 0).
    gidx = np.zeros(n_shards * budget, dtype=np.int64)
    at = 0
    for s in range(n_shards):
        c = int(counts[s])
        gidx[s * budget : s * budget + c] = perm[at : at + c]
        at += c

    spec = NamedSharding(mesh, P(mesh.axis_names[0]))
    out = []
    for a in arrays:
        taken = np.asarray(a)[gidx]
        out.append(jax.device_put(taken, spec))
    return tuple(out), local_groups, budget


def sharded_umi_group(
    mesh,
    b1,
    threshold1: int,
    by_group,
    b2=None,
    threshold2: int | None = None,
):
    """Distributed ``umi_group``: shuffle-by-pregroup, per-shard grouping,
    deterministic merge.

    Per shard, the neighbour search runs on that shard's device (the codes
    are resharded once via :func:`shuffle_by_pregroup`; each group's
    distance tiles execute where its rows live), and the tiny greedy
    clustering stays on host per group, exactly as in the single-device
    path.  The final cluster list is emitted in original pre-group order,
    and within a pre-group in greedy emission order — byte-identical to
    ``umi_group`` without a mesh.
    """
    from ..api.umi import _neighbor_csr, _csr_to_lists
    from ..native import greedy_cluster_csr
    from ..refimpl.cluster import cluster_umis

    arrays = [b1.codes.astype(np.int32), b1.lengths.astype(np.int32)]
    if b2 is not None:
        arrays += [b2.codes.astype(np.int32), b2.lengths.astype(np.int32)]
    (shards, local_groups, budget) = shuffle_by_pregroup(mesh, by_group, *arrays)

    if b2 is not None:
        c1s, l1s, c2s, l2s = shards
    else:
        c1s, l1s = shards
        c2s = l2s = None
    if threshold2 is None:
        threshold2 = threshold1

    results: dict[int, list[np.ndarray]] = {}
    # Walk shards; addressing shard s's row block of the sharded array pulls
    # only that block (on a multi-host mesh this loop runs on the owning
    # host for its own shards).
    for s, groups_here in enumerate(local_groups):
        if not groups_here:
            continue
        lo = s * budget
        c1 = np.asarray(c1s[lo : lo + budget])
        l1 = np.asarray(l1s[lo : lo + budget])
        c2 = np.asarray(c2s[lo : lo + budget]) if c2s is not None else None
        l2 = np.asarray(l2s[lo : lo + budget]) if l2s is not None else None
        for gi, loc in groups_here:
            g = by_group[gi]
            if g.size == 1:
                results[gi] = [np.asarray(g, dtype=np.int64)]
                continue
            flat, offs = _neighbor_csr(c1[loc], l1[loc], threshold1)
            if c2 is not None:
                flat2, offs2 = _neighbor_csr(c2[loc], l2[loc], threshold2)
                curn = g.size
                rq1 = np.repeat(
                    np.arange(curn, dtype=np.int64), np.diff(offs)
                )
                rq2 = np.repeat(
                    np.arange(curn, dtype=np.int64), np.diff(offs2)
                )
                keep = np.isin(
                    rq2 * curn + flat2.astype(np.int64),
                    rq1 * curn + flat.astype(np.int64),
                )
                flat = flat2[keep]
                offs = np.concatenate(
                    [[0], np.cumsum(np.bincount(rq2[keep], minlength=curn))]
                )
            clusters = greedy_cluster_csr(flat, offs)
            if clusters is None:
                clusters = cluster_umis(_csr_to_lists(flat, offs))
            results[gi] = [
                np.asarray(g, dtype=np.int64)[np.asarray(cl, dtype=np.int64)]
                for cl in clusters
            ]

    output: list[np.ndarray] = []
    for gi in range(len(by_group)):
        output.extend(results.get(gi, []))
    return output


def sharded_pregroup_msa(mesh, reads, groups, **kwargs):
    """Per-shard MSA over co-located groups, merged in original group order.

    The grouping→MSA handoff at pod scale: the UMI families produced by
    :func:`sharded_umi_group` stay on their shard for ``multi_read_align``.
    Each shard aligns only its own families; the driver merges the per-group
    alignment lists back into the global family order, so the result equals
    the single-device ``multi_read_align(reads, groups=families)`` call.
    """
    from ..api.msa import multi_read_align

    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    by_group = [np.asarray(g, dtype=np.int64) for g in groups]
    shard_of = assign_pregroups([g.size for g in by_group], n_shards)

    alignments: list = [None] * len(by_group)
    qualities: list = [None] * len(by_group)
    has_quals = False
    for s in range(n_shards):
        mine = [gi for gi in range(len(by_group)) if shard_of[gi] == s]
        if not mine:
            continue
        sub = multi_read_align(
            reads, groups=[by_group[gi] for gi in mine], **kwargs
        )
        for k, gi in enumerate(mine):
            alignments[gi] = sub["alignments"][k]
            if "qualities" in sub:
                has_quals = True
                qualities[gi] = sub["qualities"][k]

    from ..core.frame import Frame

    out = Frame(nrow=len(by_group))
    out["alignments"] = alignments
    if has_quals:
        out["qualities"] = qualities
    return out
