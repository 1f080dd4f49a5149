"""Device-mesh parallelism for the pipeline.

The reference's only parallelism is share-nothing data parallelism over reads
via BiocParallel (R/adaptorAlign.R:126-134 sharder + bpmapply dispatch); the
device mapping (SURVEY.md §2.3, §5.8) is:

* **reads axis (dp)** — batches sharded over a 1-D mesh with
  ``jax.sharding.NamedSharding``; every kernel here is batch-parallel so XLA
  partitions the column-scan DP without communication;
* **within-kernel parallelism** — the read-position axis of each DP column
  (this workload's "sequence parallelism");
* **collectives** — ``psum``/``all_gather`` replace the reference's
  driver-side list concatenation where results must be merged globally:
  score histograms for threshold calibration, cross-shard UMI distance
  blocks, gathered consensus outputs.

``shard_map`` keeps the collectives explicit; everything inside stays jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..ops.align import dp_align

__all__ = ["make_mesh", "shard_reads", "sharded_adaptor_scores", "sharded_pipeline_step"]

READS_AXIS = "reads"


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_reads(mesh: Mesh, *arrays):
    """Place batch-major arrays with their leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(READS_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def _four_scores_local(codes_f, qidx_f, lens_f, codes_b, qidx_b, lens_b, prep1, prep2, go, ge):
    """START/END/RSTART/REND fitting scores for one shard of reads."""

    def run(prep, codes, qidx, lens):
        return dp_align(
            codes,
            qidx,
            lens,
            prep[0],
            prep[1],
            prep[2],
            prep[3],
            go,
            ge,
            local=True,
            need_directions=False,
        )[0]

    s_start = run(prep1, codes_f, qidx_f, lens_f)
    s_end = run(prep2, codes_b, qidx_b, lens_b)
    s_rstart = run(prep1, codes_b, qidx_b, lens_b)
    s_rend = run(prep2, codes_f, qidx_f, lens_f)
    return s_start, s_end, s_rstart, s_rend


def sharded_adaptor_scores(
    mesh: Mesh,
    front_arrays,  # (codes, qidx, lengths) for read fronts
    back_arrays,  # (codes, qidx, lengths) for RC'd read backs
    prep1,  # (modes, matched, match_tab, mismatch_tab) adaptor1
    prep2,
    gap_opening: float,
    gap_extension: float,
    hist_bins: int = 64,
    hist_range: tuple[float, float] = (-100.0, 100.0),
):
    """Data-parallel strand-resolved adaptor scores + psum'd global histograms.

    Returns (score1 [N], score2 [N], reversed [N] — all sharded over reads —
    hist1 [bins], hist2 [bins] — replicated).  ``score1``/``score2`` are the
    per-adaptor scores in the resolved orientation (what
    ``get_adaptor_thresholds`` feeds its FDR computation,
    R/getAdaptorThresholds.R:105-128); the psum'd histograms are the
    collective ingredient of distributed threshold calibration — every host
    sees the global score distribution without gathering the reads.
    """
    spec = P(READS_AXIS)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec),
        out_specs=(spec, spec, spec, P(), P()),
        check_vma=False,
    )
    def step(codes_f, qidx_f, lens_f, codes_b, qidx_b, lens_b):
        s_start, s_end, s_rstart, s_rend = _four_scores_local(
            codes_f, qidx_f, lens_f, codes_b, qidx_b, lens_b, prep1, prep2,
            gap_opening, gap_extension,
        )
        fscore = jnp.maximum(s_start, 0) + jnp.maximum(s_end, 0)
        rscore = jnp.maximum(s_rstart, 0) + jnp.maximum(s_rend, 0)
        reversed_ = fscore < rscore
        score1 = jnp.where(reversed_, s_rstart, s_start)
        score2 = jnp.where(reversed_, s_rend, s_end)

        # Global per-adaptor score histograms via psum.  Padding
        # rows (batch rounded up to the mesh size) have zero-length ends and
        # are dropped from the histogram.
        lo, hi = hist_range
        valid = jnp.logical_or(lens_f > 0, lens_b > 0)

        def hist_of(s):
            idx = jnp.clip(
                ((s - lo) / (hi - lo) * hist_bins).astype(jnp.int32),
                0,
                hist_bins - 1,
            )
            idx = jnp.where(valid, idx, hist_bins)  # out of range -> dropped
            return jax.lax.psum(
                jnp.zeros(hist_bins, jnp.int32).at[idx].add(1, mode="drop"),
                READS_AXIS,
            )

        return score1, score2, reversed_, hist_of(score1), hist_of(score2)

    return step(*front_arrays, *back_arrays)


def sharded_pipeline_step(
    mesh: Mesh,
    front_arrays,
    back_arrays,
    prep1,
    prep2,
    umi_codes,  # [N, LU] int32 — per-read UMI codes (dp-sharded)
    umi_lengths,  # [N]
    gap_opening: float,
    gap_extension: float,
):
    """One full data-parallel pipeline step for multi-chip validation.

    Covers every communication pattern the production pipeline needs:
    batch-parallel DP (no comms), a psum'd score histogram, and an
    ``all_gather`` of shard-local UMIs so every shard can compute its block
    of the cross-shard UMI distance matrix (the distributed ``umi_group``
    ingredient — each shard computes distances of *its* UMIs against *all*
    UMIs).  Returns (final_scores, reversed, hist, dist_block) with
    dist_block sharded over rows.
    """
    from ..ops.levenshtein import lev2_pairs

    spec = P(READS_AXIS)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec, spec, spec),
        out_specs=(spec, spec, P(), spec),
        check_vma=False,
    )
    def step(codes_f, qidx_f, lens_f, codes_b, qidx_b, lens_b, ucodes, ulens):
        s_start, s_end, s_rstart, s_rend = _four_scores_local(
            codes_f, qidx_f, lens_f, codes_b, qidx_b, lens_b, prep1, prep2,
            gap_opening, gap_extension,
        )
        fscore = jnp.maximum(s_start, 0) + jnp.maximum(s_end, 0)
        rscore = jnp.maximum(s_rstart, 0) + jnp.maximum(s_rend, 0)
        reversed_ = fscore < rscore
        final = jnp.where(reversed_, rscore, fscore)

        bins = 64
        idx = jnp.clip(((final + 100.0) / 200.0 * bins).astype(jnp.int32), 0, bins - 1)
        hist = jax.lax.psum(jnp.zeros(bins, jnp.int32).at[idx].add(1), READS_AXIS)

        # Cross-shard UMI distances: gather all UMIs, compute local-vs-all.
        all_u = jax.lax.all_gather(ucodes, READS_AXIS, tiled=True)  # [N, LU]
        all_l = jax.lax.all_gather(ulens, READS_AXIS, tiled=True)  # [N]
        nloc = ucodes.shape[0]
        ntot = all_u.shape[0]
        ca = jnp.repeat(ucodes, ntot, axis=0)
        la = jnp.repeat(ulens, ntot, axis=0)
        cb = jnp.tile(all_u, (nloc, 1))
        lb = jnp.tile(all_l, (nloc,))
        d2 = lev2_pairs(ca, la, cb, lb).reshape(nloc, ntot)
        return final, reversed_, hist, d2

    return step(*front_arrays, *back_arrays, umi_codes, umi_lengths)
