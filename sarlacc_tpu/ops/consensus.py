"""Batched consensus calling on device.

Batched re-design of ``src/create_consensus.cpp``: instead of one MSA at a
time through scalar loops, *batches of padded MSAs* are tallied together —
the per-column/per-base reductions over group members are dense one-hot
sums, and everything downstream (argmax, the incremental-logsumexp error)
is elementwise over the ``(group, column)`` plane.

Both modes reproduce the reference's arithmetic exactly (file:line cites into
/root/reference):

* **basic** (create_consensus.cpp:61-135): A/C/G/T counts with a separate
  incidence count ('-' absent, 'N' present-but-uncounted); consensus = first
  max count; err = log1p(-(max + pseudo/4) / (total + pseudo)).
* **quality** (create_consensus.cpp:178-272): per-base log-prob sums with
  right = log1p(-eps), wrong = log(eps/3), eps clamped to
  [1e-8, 0.99999999]; consensus = first argmax; error computed by sorting
  the four sums ascending and accumulating R-style ``log1pexp`` increments
  in the same order as the C++ (:250-268).

Column filtering (incidences >= naligns * min_cov) happens on device; the
ragged assembly of consensus strings happens on the host.

Two input layouts:

* padded — ``codes[B, G, W]`` int8 (A=0..T=3, N=4, '-'/pad=5) with
  ``naligns[B]`` true group sizes, and for quality mode ``eps[B, G, W]``
  error probabilities aligned to *gapped* columns.  Used on the mesh path
  (the padded batch shards over devices).
* flat — the ragged groups travel as ONE concatenated byte stream plus tiny
  ``(gstart, widths, naligns)`` descriptors, and the padded planes are
  rebuilt on device by a gather.  The padded host batch is ~3x the real
  data at 4-5 bytes/cell (int8 codes + f32 eps); the flat path moves 1-2
  bytes per REAL cell.
  Quality chars ride as raw uint8 (255 = gap/no-quality -> eps 0.5) and
  dequantize through a 256-entry table on device; the per-column Phred
  string chars (create_consensus.cpp:18-32) are also computed on device so
  the readback is uint8, not f64.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "consensus_basic_dev",
    "consensus_quality_dev",
    "consensus_basic_flat_dev",
    "consensus_quality_flat_dev",
    "log1pexp_dev",
    "quality_lut",
]


def log1pexp_dev(x):
    """R's log1pexp piecewise evaluation (create_consensus.cpp:8-12 via Rmath)."""
    return jnp.where(
        x <= -37.0,
        jnp.exp(x),
        jnp.where(
            x <= 18.0,
            jnp.log1p(jnp.exp(jnp.minimum(x, 18.0))),
            jnp.where(x <= 33.3, x + jnp.exp(-jnp.maximum(x, 18.0)), x),
        ),
    )


def _basic_core(codes, naligns, min_cov, pseudo_count):
    dtype = jnp.result_type(pseudo_count, jnp.float32)
    onehot = (codes[..., None] == jnp.arange(4, dtype=codes.dtype)).astype(dtype)
    counts = onehot.sum(axis=1)  # [B, W, 4]
    incidences = (codes != 5).sum(axis=1)  # [B, W] ('-' and padding excluded)

    keep = incidences.astype(dtype) >= naligns[:, None].astype(dtype) * min_cov
    best = jnp.argmax(counts, axis=-1).astype(jnp.int8)  # first max
    maxed = jnp.max(counts, axis=-1)
    total = counts.sum(axis=-1)
    pseudo_num = pseudo_count / 4.0
    err = jnp.log1p(-(maxed + pseudo_num) / (total + pseudo_count))
    return keep, best, err


@jax.jit
def consensus_basic_dev(codes, naligns, min_cov, pseudo_count):
    """codes [B,G,W] int8 -> (keep [B,W] bool, best [B,W] int8, err [B,W] f).

    ``err`` is the natural-log error probability for kept columns.
    """
    return _basic_core(codes, naligns, min_cov, pseudo_count)


MAX_ERROR = 0.99999999
MIN_ERROR = 0.00000001


def _quality_core(codes, eps, naligns, min_cov):
    dtype = eps.dtype
    is_base = codes < 4  # A/C/G/T add right to their own base
    # Unknown characters (host encodes them as 6) score `wrong` against every
    # base — the quality mode never rejects them (create_consensus.cpp:229-232).
    scoring = jnp.logical_or(is_base, codes == 6)
    present = codes != 5  # N also counts toward incidence

    e = jnp.clip(eps, MIN_ERROR, MAX_ERROR)
    right = jnp.log1p(-e)
    wrong = jnp.log(e / 3.0)

    wrong_sum = jnp.sum(jnp.where(scoring, wrong, 0.0), axis=1)  # [B, W]
    onehot = (codes[..., None] == jnp.arange(4, dtype=codes.dtype)).astype(dtype)
    delta = jnp.sum(onehot * jnp.where(is_base, right - wrong, 0.0)[..., None], axis=1)
    scores = wrong_sum[..., None] + delta  # [B, W, 4]

    incidences = present.sum(axis=1)
    keep = incidences.astype(dtype) >= naligns[:, None].astype(dtype) * min_cov
    best = jnp.argmax(scores, axis=-1).astype(jnp.int8)  # first max

    # Incremental logsumexp in ascending order (create_consensus.cpp:250-268).
    v = jnp.sort(scores, axis=-1)  # ascending
    d = v[..., 0]
    d = d + log1pexp_dev(v[..., 1] - d)
    err_num = d + log1pexp_dev(v[..., 2] - d)  # after k == 2
    d_all = err_num + log1pexp_dev(v[..., 3] - err_num)
    err = err_num - d_all
    return keep, best, err


@jax.jit
def consensus_quality_dev(codes, eps, naligns, min_cov):
    """codes [B,G,W] int8, eps [B,G,W] float -> (keep, best, err) as above."""
    return _quality_core(codes, eps, naligns, min_cov)


def _phred_chars(err):
    """Natural-log error -> Phred+33 char codes on device
    (create_consensus.cpp:18-32; mirrors core.quality.errors_to_phred_string:
    std::round == floor(x + 0.5) for the non-negative operand)."""
    ln10 = jnp.log(jnp.asarray(10.0, err.dtype))
    to_ascii = jnp.minimum(jnp.floor(-10.0 * err / ln10 + 0.5), 93.0)
    return (to_ascii + 33.0).astype(jnp.uint8)


def _expand_flat(flat, gstart, widths, naligns, G: int, W: int, fill):
    """[F] flat member-major stream -> padded [B, G, W] plane via gather.

    Group k's member m occupies flat[gstart[k] + m*widths[k] : +widths[k]];
    cells outside (padded members/columns) take ``fill``.
    """
    m = jnp.arange(G, dtype=jnp.int32)[None, :, None]
    c = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    wk = widths[:, None, None].astype(jnp.int32)
    idx = gstart[:, None, None].astype(jnp.int32) + m * wk + c
    valid = (m < naligns[:, None, None].astype(jnp.int32)) & (c < wk)
    vals = flat[jnp.clip(idx, 0, flat.shape[0] - 1)]
    return jnp.where(valid, vals, fill), valid


@functools.partial(jax.jit, static_argnames=("G", "W"))
def consensus_basic_flat_dev(
    flat_codes, gstart, widths, naligns, min_cov, pseudo_count, G: int, W: int
):
    """Flat-layout basic consensus: returns (keep, best, qchar [B,W] uint8)."""
    codes, _ = _expand_flat(
        flat_codes, gstart, widths, naligns, G, W, jnp.int8(5)
    )
    keep, best, err = _basic_core(codes, naligns, min_cov, pseudo_count)
    return keep, best, _phred_chars(err)


@functools.partial(jax.jit, static_argnames=("G", "W"))
def consensus_quality_flat_dev(
    flat_codes, flat_quals, lut, gstart, widths, naligns, min_cov,
    G: int, W: int,
):
    """Flat-layout quality consensus.

    ``flat_quals`` carries raw quality char codes (255 at gaps and padding);
    ``lut`` [256] maps char code -> error probability with lut[255] = 0.5,
    reproducing the host expansion's 0.5 at non-scoring cells.
    """
    codes, _ = _expand_flat(
        flat_codes, gstart, widths, naligns, G, W, jnp.int8(5)
    )
    q, _ = _expand_flat(
        flat_quals, gstart, widths, naligns, G, W, jnp.uint8(255)
    )
    eps = lut[q.astype(jnp.int32)]
    keep, best, err = _quality_core(codes, eps, naligns, min_cov)
    return keep, best, _phred_chars(err)


def quality_lut(encoding) -> np.ndarray:
    """256-entry char-code -> error-probability table for the device path.

    Entries below the encoding offset are never gathered (the host validates
    chars >= offset before upload — quality_encoding.cpp:38-41 raises there);
    index 255 is the gap/no-quality sentinel -> 0.5 (create_consensus.cpp
    ignores those cells; 0.5 matches the padded path's fill).
    """
    lut = np.full(256, 0.5, np.float64)
    codes = np.arange(encoding.offset, 255)
    lut[codes] = encoding.errors[
        np.minimum(codes - encoding.offset, encoding.size - 1)
    ]
    return lut
