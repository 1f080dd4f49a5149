"""Masked-Levenshtein kernel tests (reference test-levenshtein.R model).

The in-test oracle is an independently written plain Levenshtein with the
masking rules; the shipped implementations (refimpl + device kernel) must
agree at thresholds, under duplicates, empties, and N-masking — including
the "N vs N = 0.5" rule (test-levenshtein.R:31-46,122-138).
"""

import numpy as np
import pytest

from sarlacc_tpu.api.umi import _neighbor_lists, expected_dist
from sarlacc_tpu.core.encode import encode_batch
from sarlacc_tpu.ops.levenshtein import lev2_condensed, lev2_matrix
from sarlacc_tpu.refimpl.levenshtein import (
    find_neighbors,
    lev2_int,
    lev_masked_condensed,
)


def slow_lev(a: str, b: str) -> float:
    """Independent masked Levenshtein, recursive definition memoized."""
    import functools

    @functools.lru_cache(maxsize=None)
    def rec(i, j):
        if i == 0:
            return float(j)
        if j == 0:
            return float(i)
        ca, cb = a[i - 1], b[j - 1]
        sub = 0.5 if "N" in (ca, cb) else (0.0 if ca == cb else 1.0)
        return min(rec(i - 1, j) + 1, rec(i, j - 1) + 1, rec(i - 1, j - 1) + sub)

    return rec(len(a), len(b))


def rand_seqs(rng, n, minl=4, maxl=10, p_n=0.1):
    p = [(1 - p_n) / 4] * 4 + [p_n]
    return [
        "".join(rng.choice(list("ACGTN"), int(rng.integers(minl, maxl + 1)), p=p))
        for _ in range(n)
    ]


def test_pairwise_against_slow_oracle(rng):
    seqs = rand_seqs(rng, 20)
    codes, lengths = encode_batch(seqs)
    mat = lev2_matrix(codes.astype(np.int32), lengths)
    for i in range(len(seqs)):
        for j in range(len(seqs)):
            expect = slow_lev(seqs[i], seqs[j])
            assert mat[i, j] / 2.0 == expect, (seqs[i], seqs[j])
            assert lev2_int(seqs[i], seqs[j]) / 2.0 == expect


def test_condensed_matches_refimpl(rng):
    seqs = rand_seqs(rng, 30)
    codes, lengths = encode_batch(seqs)
    dev = lev2_condensed(codes.astype(np.int32), lengths).astype(float) / 2.0
    ref = lev_masked_condensed(seqs)
    assert np.array_equal(dev, ref)
    assert np.array_equal(expected_dist(seqs), ref)


def test_n_vs_n_half():
    assert lev2_int("N", "N") == 1  # doubled 0.5
    assert slow_lev("N", "N") == 0.5
    assert lev2_int("AN", "AN") == 1
    assert lev2_int("ANA", "AA") == 2  # indel of N costs 1.0 doubled


def test_empty_strings():
    assert lev2_int("", "") == 0
    assert lev2_int("", "ACG") == 6
    assert lev2_int("ACG", "") == 6
    codes, lengths = encode_batch(["", "ACG", ""])
    mat = lev2_matrix(codes.astype(np.int32), lengths)
    assert mat[0, 1] == 6 and mat[0, 2] == 0


@pytest.mark.parametrize("limit", [2, 5])
def test_neighbor_sets_match_trie_oracle(rng, limit):
    # Sorted and unsorted query orders give identical per-query sets
    # (test-levenshtein.R:57-83); dense duplicate space (:86-103).
    seqs = rand_seqs(rng, 25, 4, 6, p_n=0.05) + ["ACGT"] * 5
    codes, lengths = encode_batch(seqs)
    dev = _neighbor_lists(codes.astype(np.int32), lengths, limit)
    ref = find_neighbors(seqs, limit)
    assert dev == [list(map(int, x)) for x in ref]


@pytest.mark.parametrize("limit", [1, 2, 5])
def test_sparse_neighbor_pairs_match_dense(rng, limit):
    """The sparse row-block kernel's surviving (i, j) pairs equal the dense
    matrix thresholded — duplicates, Ns, empties and mixed lengths."""
    from sarlacc_tpu.ops.levenshtein import lev2_neighbor_pairs

    seqs = rand_seqs(rng, 40, 2, 9, p_n=0.1) + ["ACGT"] * 6 + ["", "N"]
    codes, lengths = encode_batch(seqs)
    codes = codes.astype(np.int32)
    mat = lev2_matrix(codes, lengths)
    qi, qj = lev2_neighbor_pairs(codes, lengths, limit, tile=16, kcap=4)
    got = set(zip(qi.tolist(), qj.tolist()))
    want = {
        (i, j)
        for i in range(len(seqs))
        for j in range(i, len(seqs))
        if mat[i, j] <= 2 * limit
    }
    assert got == want


@pytest.mark.parametrize("limit", [2, 5])
def test_sparse_neighbor_lists_match_dense_path(rng, limit, monkeypatch):
    """CSR assembly (dedup + expansion + DFS ordering) is byte-identical to
    the dense path and hence to the trie oracle."""
    import sarlacc_tpu.api.umi as umi_mod

    seqs = rand_seqs(rng, 30, 4, 6, p_n=0.05) + ["ACGT"] * 8 + ["N", "N"]
    codes, lengths = encode_batch(seqs)
    codes = codes.astype(np.int32)
    dense = _neighbor_lists(codes, lengths, limit)
    monkeypatch.setattr(umi_mod, "SPARSE_MIN", 1)
    sparse = _neighbor_lists(codes, lengths, limit)
    assert sparse == dense
    ref = find_neighbors(seqs, limit)
    assert sparse == [list(map(int, x)) for x in ref]


def test_umi_group_collapsed_clusterer_parity(rng, monkeypatch):
    """The unique-level weighted greedy clusterer (single-UMI scale path)
    reproduces the read-level clusterer byte for byte — duplicates, Ns,
    singleton ordering, tie-breaks."""
    from sarlacc_tpu.api.umi import umi_group
    import sarlacc_tpu.api.umi as umi_mod

    for trial in range(4):
        base = rand_seqs(rng, 40, 5, 7, p_n=0.04)
        # Heavy duplication so the collapsed graph differs from the
        # read-level one, plus shuffling so maxidx tie-breaks matter.
        seqs = base + [base[i % len(base)] for i in range(60)] + ["ACGTA"] * 9
        order = rng.permutation(len(seqs))
        seqs = [seqs[i] for i in order]
        dense = umi_group(seqs, threshold1=2)
        monkeypatch.setattr(umi_mod, "SPARSE_MIN", 1)
        collapsed = umi_group(seqs, threshold1=2)
        monkeypatch.setattr(umi_mod, "SPARSE_MIN", 2048)
        assert len(dense) == len(collapsed), trial
        for a, b in zip(dense, collapsed):
            assert np.array_equal(a, b), trial


def test_umi_group_sparse_path_parity(rng, monkeypatch):
    """umi_group end-to-end (incl. dual-UMI intersection) is unchanged when
    the sparse kernel replaces the dense matrix."""
    from sarlacc_tpu.api.umi import umi_group
    import sarlacc_tpu.api.umi as umi_mod

    u1 = rand_seqs(rng, 50, 5, 7, p_n=0.05) + ["ACGTA"] * 10
    u2 = rand_seqs(rng, 50, 5, 7, p_n=0.05) + ["TTGCA"] * 10
    dense = umi_group(u1, threshold1=2, umi2=u2, threshold2=2)
    monkeypatch.setattr(umi_mod, "SPARSE_MIN", 1)
    sparse = umi_group(u1, threshold1=2, umi2=u2, threshold2=2)
    assert len(dense) == len(sparse)
    for a, b in zip(dense, sparse):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("limit", [0, 1, 2, 3])
def test_filter_engine_matches_rowblock(rng, limit):
    """The symmetric-delete filter engine and the row-block scan produce the
    same unique-space neighbour pairs — mixed lengths, Ns, duplicates."""
    from sarlacc_tpu.ops.levenshtein import (
        _neighbor_pairs_filtered,
        _neighbor_pairs_rowblock,
        lev2_neighbor_pairs,
    )

    seqs = rand_seqs(rng, 300, 6, 12, p_n=0.03) + ["ACGTACGT"] * 4 + [""]
    codes, lengths = encode_batch(seqs)
    codes = np.ascontiguousarray(codes, np.int8)
    uniq, uid = np.unique(codes, axis=0, return_inverse=True)
    ulen = np.zeros(uniq.shape[0], np.int32)
    ulen[uid.ravel()] = lengths.astype(np.int32)
    thr = 2 * limit
    fa, fb = _neighbor_pairs_filtered(uniq, ulen, limit, thr)
    ra, rb = _neighbor_pairs_rowblock(uniq, ulen, thr, limit, 64, 16)
    f = {(min(a, b), max(a, b)) for a, b in zip(fa.tolist(), fb.tolist())}
    r = {(min(a, b), max(a, b)) for a, b in zip(ra.tolist(), rb.tolist())}
    assert f == r

    # And end-to-end through the public entry point (read space).
    qi, qj = lev2_neighbor_pairs(codes.astype(np.int32), lengths, limit)
    mat = lev2_matrix(codes.astype(np.int32), lengths)
    want = {
        (i, j)
        for i in range(len(seqs))
        for j in range(i, len(seqs))
        if mat[i, j] <= thr
    }
    assert set(zip(qi.tolist(), qj.tolist())) == want


def test_candidate_pairs_native_matches_numpy(rng):
    """C++ candidate_pairs == the numpy fallback (sorted pair sets)."""
    import sarlacc_tpu.native as nat
    from sarlacc_tpu.ops.levenshtein import _candidate_pairs_from_entries

    if not nat.native_available():
        pytest.skip("native library unavailable")
    h = rng.integers(0, 50, 5000).astype(np.uint64)
    owner = rng.integers(0, 40, 5000).astype(np.int64)
    native = _candidate_pairs_from_entries(h, owner, 1 << 24)

    import unittest.mock as mock

    with mock.patch.object(nat, "get_lib", lambda: None):
        fallback = _candidate_pairs_from_entries(h, owner, 1 << 24)
    na = sorted(map(tuple, native.tolist()))
    fb = sorted(map(tuple, fallback.tolist()))
    assert na == fb


def test_tile_kernel_wide_matches_int16():
    """The wide (int32) tile readback is value-identical to the int16 path
    for short sequences; long sequences (>16383) must select it to avoid
    wraparound."""
    from sarlacc_tpu.ops.levenshtein import _lev2_tile_kernel
    import jax.numpy as jnp

    codes, lengths = encode_batch(["ACGT", "AGGT", "TTTT", ""])
    cp = np.full((4, 8), 5, np.int32)
    cp[:, :4] = codes[:, :4]
    a16 = np.asarray(
        _lev2_tile_kernel(jnp.asarray(cp), jnp.asarray(lengths.astype(np.int32)),
                          0, 0, TI=4, TJ=4, L=8, wide=False)
    )
    a32 = np.asarray(
        _lev2_tile_kernel(jnp.asarray(cp), jnp.asarray(lengths.astype(np.int32)),
                          0, 0, TI=4, TJ=4, L=8, wide=True)
    )
    assert a32.dtype == np.int32
    np.testing.assert_array_equal(a16.astype(np.int32), a32)
