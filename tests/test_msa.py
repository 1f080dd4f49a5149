"""MSA tests: degapped reconstruction, consensus recovery, masking wiring,
band robustness, and group handling (reference quick_msa semantics)."""

import numpy as np
import pytest

from sarlacc_tpu.api.consensus import consensus_read_seq
from sarlacc_tpu.api.msa import multi_read_align
from sarlacc_tpu.core.encode import SeqBatch
from sarlacc_tpu.ops.msa import banded_pair_align
from sarlacc_tpu.refimpl.levenshtein import lev2_int


def noisy_copies(rng, ref, n, sub=0.05, indel=0.01):
    out = []
    for _ in range(n):
        s = []
        for ch in ref:
            r = rng.random()
            if r < indel / 2:
                continue
            if r < indel:
                s.append(ch)
                s.append(ch)
            s.append(str(rng.choice(list("ACGT"))) if rng.random() < sub else ch)
        out.append("".join(s))
    return out


def test_msa_reconstruction_and_consensus(rng):
    ref = "".join(rng.choice(list("ACGT"), 200))
    seqs = noisy_copies(rng, ref, 7)
    batch = SeqBatch.from_strings(seqs, ["I" * len(s) for s in seqs])
    out = multi_read_align(batch, bandwidth=40)
    aln = out["alignments"][0]
    assert len(set(map(len, aln))) == 1
    assert all(a.replace("-", "") == s for a, s in zip(aln, seqs))
    cons = consensus_read_seq(out)
    assert lev2_int(cons.seq_strings()[0], ref) <= 4  # near-perfect recovery


def test_hand_derived_msa_goldens():
    """Curated groups whose optimal multiple alignment is unique and written
    down by hand — T-Coffee-layer bugs cannot hide behind co-optimality
    (quick_msa.cpp:39-75 semantics).

    With the default scores (match 0, mismatch -1, open 5, extend 1) a
    single gap costs 6, so substitution columns always beat compensating
    gap pairs, and every deletion below sits between two distinct letters so
    the gap column cannot slide.
    """
    cases = [
        # 1. Identical reads: no gaps anywhere.
        (["ACGTTGCA"] * 3, ["ACGTTGCA"] * 3),
        # 2. One substitution: gapless alignment is uniquely optimal
        #    (1 mismatch = -1 vs >= -12 for any gap pairing).
        (
            ["ACGTTGCA", "ACGATGCA", "ACGTTGCA"],
            ["ACGTTGCA", "ACGATGCA", "ACGTTGCA"],
        ),
        # 3. Single internal deletion at a unique-letter context: the gap
        #    must sit exactly where the A was (between T and G).
        (
            ["ACGTAGCT", "ACGTGCT", "ACGTAGCT"],
            ["ACGTAGCT", "ACGT-GCT", "ACGTAGCT"],
        ),
        # 4. Majority short: the long read carries the only full column.
        (
            ["ACGTGCT", "ACGTGCT", "ACGTAGCT"],
            ["ACGT-GCT", "ACGT-GCT", "ACGTAGCT"],
        ),
        # 5. Two distinct unique-context deletions (middle + leading edge).
        (
            ["ACGTAGCT", "ACGTGCT", "CGTAGCT"],
            ["ACGTAGCT", "ACGT-GCT", "-CGTAGCT"],
        ),
        # 6. Two-base internal deletion: "AT" removed between G and C.  The
        #    only length-2 window of ACGATCGT whose removal yields ACGCGT is
        #    positions 4-5 (the subsequence embedding A1 C2 G3 C6 G7 T8 is
        #    unique), and an adjacent gap run (5+1) beats two split gaps
        #    (5+5), so the gap run's position is forced.
        (
            ["ACGATCGT", "ACGCGT", "ACGATCGT"],
            ["ACGATCGT", "ACG--CGT", "ACGATCGT"],
        ),
        # 7. INSERTION in one read of four: read 3 carries an extra A
        #    between T and G; every other read takes a gap column there.
        #    Unique: the only single-char removal of ACGTAGCAT that yields
        #    ACGTGCAT is position 5 (prefix ACGT matches greedily and G has
        #    no earlier candidate).
        (
            ["ACGTGCAT", "ACGTGCAT", "ACGTAGCAT", "ACGTGCAT"],
            ["ACGT-GCAT", "ACGT-GCAT", "ACGTAGCAT", "ACGT-GCAT"],
        ),
        # 8. Five reads, two DIFFERENT single deletions in different reads
        #    (read 2 misses the col-5 A, read 4 misses the col-7 C), each
        #    uniquely placed against the three full-length reads.  The
        #    read2~read4 pairwise optimum is gapless (2 mismatches = -2
        #    beats two gaps), i.e. inconsistent with the true homology —
        #    the three 100-weight full-read libraries must outvote it.
        (
            ["ACGTAGCTA", "ACGTGCTA", "ACGTAGCTA", "ACGTAGTA", "ACGTAGCTA"],
            ["ACGTAGCTA", "ACGT-GCTA", "ACGTAGCTA", "ACGTAG-TA", "ACGTAGCTA"],
        ),
        # 9. Six reads: one deletion (read 2) + one substitution (read 4)
        #    at the same column.  The del~sub pairwise gap is still unique
        #    (ACGTGCAT embeds in ACGTCGCAT only by skipping the C at 5), so
        #    every pairwise optimum is consistent with the hand answer.
        (
            [
                "ACGTAGCAT", "ACGTGCAT", "ACGTAGCAT",
                "ACGTCGCAT", "ACGTAGCAT", "ACGTAGCAT",
            ],
            [
                "ACGTAGCAT", "ACGT-GCAT", "ACGTAGCAT",
                "ACGTCGCAT", "ACGTAGCAT", "ACGTAGCAT",
            ],
        ),
        # 10. Forced guide-tree merge order: two identical-pair clusters
        #     (within-cluster identity 1.0, cross 7/8), so NJ must merge
        #     each cherry first and the final PROFILE-profile merge has to
        #     open the shared gap column from the four cross-pair library
        #     entries alone (the within-B pairwise alignment is gapless and
        #     says nothing about column 5).
        (
            ["ACGTAGCAT", "ACGTAGCAT", "TCGTGCAT", "TCGTGCAT"],
            ["ACGTAGCAT", "ACGTAGCAT", "TCGT-GCAT", "TCGT-GCAT"],
        ),
        # 11. Leading and trailing truncations in one group: terminal gap
        #     runs at both edges.  The trunc~trunc pairwise optimum is the
        #     7-mismatch gapless alignment (identity 0 -> library weight 0),
        #     so only the full-length reads place the truncated ones.
        (
            ["ACGTAGCAT", "GTAGCAT", "ACGTAGCAT", "ACGTAGC"],
            ["ACGTAGCAT", "--GTAGCAT", "ACGTAGCAT", "ACGTAGC--"],
        ),
    ]
    for seqs, want in cases:
        out = multi_read_align(SeqBatch.from_strings(seqs))
        assert out["alignments"][0] == want, (seqs, out["alignments"][0])


def test_segment_budget_env_override(rng, monkeypatch):
    """SARLACC_MSA_SEG_BUDGET_GB changes only the segment packing, never
    the alignment strings."""
    from sarlacc_tpu.api.msa import _segment_lib_budget

    seqs = [
        ["ACGTAGCTA", "ACGTGCTA", "ACGTAGCTA"],
        ["TTGCAGGAT", "TTGCAGAT", "TTGCAGGAT"],
        ["ACGTAGCAT", "ACGTAGCAT", "TCGTGCAT"],
    ]
    flat = [s for g in seqs for s in g]
    groups = [list(range(i * 3, i * 3 + 3)) for i in range(3)]
    base = multi_read_align(SeqBatch.from_strings(flat), groups=groups)

    monkeypatch.setenv("SARLACC_MSA_SEG_BUDGET_GB", "2")
    assert _segment_lib_budget() == 2 << 30
    out = multi_read_align(SeqBatch.from_strings(flat), groups=groups)
    assert out["alignments"] == base["alignments"]

    # Tiny budget forces one group per segment; output still identical.
    monkeypatch.setenv("SARLACC_MSA_SEG_BUDGET_GB", "0.0001")
    assert _segment_lib_budget() == 64 << 20
    out = multi_read_align(SeqBatch.from_strings(flat), groups=groups)
    assert out["alignments"] == base["alignments"]


def test_single_and_empty_groups(rng):
    batch = SeqBatch.from_strings(["ACGTACGT", "ACGTACGA", "TTTT"])
    out = multi_read_align(batch, groups=[[2], [], [0, 1]])
    assert out["alignments"][0] == ["TTTT"]
    assert out["alignments"][1] == []
    assert [a.replace("-", "") for a in out["alignments"][2]] == [
        "ACGTACGT",
        "ACGTACGA",
    ]


def test_group_length_mismatch():
    batch = SeqBatch.from_strings(["ACGT", "ACGT"])
    with pytest.raises(ValueError, match="same"):
        multi_read_align(batch, groups=np.array([0, 0, 1]))


def test_long_read_guard(rng):
    """>32 kb reads would overflow the int16 position tensors; the reference
    caps nothing (DNA_input.cpp:106-116), so the boundary must be an
    explicit error, not silent wraparound."""
    long_read = "".join(rng.choice(list("ACGT"), 40_000))
    batch = SeqBatch.from_strings([long_read, long_read[:39_000]])
    with pytest.raises(ValueError, match="32000"):
        multi_read_align(batch)


def test_masking_wired(rng):
    # max_error masks low-quality bases for alignment but the output strings
    # restore the original bases (the reference documents this but never
    # wired it; we do).
    seqs = ["ACGTACGT", "ACGTACGT"]
    quals = ["II#IIIII", "IIIIIIII"]  # read 1 has one terrible base
    batch = SeqBatch.from_strings(seqs, quals)
    out = multi_read_align(batch, max_error=0.01)
    aln = out["alignments"][0]
    assert all(a.replace("-", "") == s for a, s in zip(aln, seqs))
    out_keep = multi_read_align(batch, max_error=0.01, keep_mask=True)
    assert "N" in out_keep["alignments"][0][0]


def test_qualities_column(rng):
    seqs = ["ACGT", "ACGA"]
    quals = ["IIII", "JJJJ"]
    out = multi_read_align(SeqBatch.from_strings(seqs, quals))
    assert out["qualities"][0] == quals
    out2 = multi_read_align(SeqBatch.from_strings(seqs))
    assert "qualities" not in out2


def test_banded_pair_align_scores(rng):
    # Identical sequences: score = match * len; one substitution: +mismatch-match.
    codes = np.zeros((2, 8), np.int32)
    codes[0] = [0, 1, 2, 3, 0, 1, 2, 3]
    codes[1] = codes[0]
    lens = np.full(2, 8, np.int32)
    sub = codes.copy()
    sub[1, 3] = 0
    scores, paths = banded_pair_align(
        codes, lens, sub, lens, match=0, mismatch=-1, gap_open=5, gap_ext=1, bandwidth=4
    )
    assert scores[0] == 0.0
    assert scores[1] == -1.0
    ai, bi = paths[0]
    assert ai.tolist() == list(range(1, 9))
    assert bi.tolist() == list(range(1, 9))


def test_banded_pair_align_length_difference(rng):
    # Length difference beyond the raw bandwidth still aligns corner to
    # corner (our band widening deviation).
    a = "".join(rng.choice(list("ACGT"), 60))
    b = a[:20] + a[40:]  # 20-base deletion
    from sarlacc_tpu.core.encode import encode_batch

    codes, lengths = encode_batch([a, b])
    scores, paths = banded_pair_align(
        codes[:1].astype(np.int32),
        lengths[:1],
        codes[1:].astype(np.int32),
        lengths[1:],
        match=0,
        mismatch=-1,
        gap_open=5,
        gap_ext=1,
        bandwidth=5,
    )
    # One 20-gap: -(5 + 19).
    assert scores[0] == -(5 + 19)


def _gotoh_banded(a, b, lo, hi, match, mismatch, go, ge):
    """Full-matrix Gotoh global alignment score with SeqAn's gap convention
    (a gap of length k costs go + (k-1)*ge); cells off the diagonal band
    lo <= j - i <= hi are unreachable."""
    la, lb = len(a), len(b)
    neg = float("-inf")
    S = [[neg] * (lb + 1) for _ in range(la + 1)]
    H = [[neg] * (lb + 1) for _ in range(la + 1)]
    V = [[neg] * (lb + 1) for _ in range(la + 1)]
    S[0][0] = 0.0
    for i in range(la + 1):
        for j in range(max(0, i + lo), min(lb, i + hi) + 1):
            if i == 0 and j == 0:
                continue
            h = max(S[i][j - 1] - go, H[i][j - 1] - ge) if j else neg
            v = max(S[i - 1][j] - go, V[i - 1][j] - ge) if i else neg
            m = neg
            if i and j:
                m = S[i - 1][j - 1] + (match if a[i - 1] == b[j - 1] else mismatch)
            H[i][j], V[i][j] = h, v
            S[i][j] = max(m, h, v)
    return S[la][lb]


def _path_score(a, b, ai, bi, match, mismatch, go, ge):
    """Score of the alignment whose aligned (diagonal) columns are
    (ai, bi), 1-based; runs between them are gaps."""

    def gap(k):
        return 0.0 if k == 0 else -(go + (k - 1) * ge)

    sc, pa, pb = 0.0, 0, 0
    for x, y in zip(list(ai) + [len(a) + 1], list(bi) + [len(b) + 1]):
        assert x > pa and y > pb
        sc += gap(x - pa - 1) + gap(y - pb - 1)
        if x <= len(a):
            sc += match if a[x - 1] == b[y - 1] else mismatch
        pa, pb = x, y
    return sc


def _pair_case(rng, la_range, d_range, n):
    """n pairs: b is a noisy copy of a with a block of d bases inserted."""
    seq_a, seq_b = [], []
    for _ in range(n):
        la = int(rng.integers(*la_range))
        d = int(rng.integers(*d_range))
        a = "".join(rng.choice(list("ACGT"), la))
        b = list(a)
        for _ in range(la // 20):
            b[int(rng.integers(0, la))] = str(rng.choice(list("ACGT")))
        at = int(rng.integers(0, la + 1))
        ins = "".join(rng.choice(list("ACGT"), abs(d)))
        if d >= 0:
            b = b[:at] + list(ins) + b[at:]
        else:
            b = b[:at] + b[at - d :]
        seq_a.append(a)
        seq_b.append("".join(b) or "A")
    return seq_a, seq_b


@pytest.mark.parametrize(
    "bucket,la_range,d_range,n",
    [
        ((64, 128), (40, 65), (52, 100), 12),
        ((128, 64), (65, 129), (-20, 21), 12),
        ((256, 256), (129, 200), (116, 150), 6),
        ((512, 1024), (257, 290), (500, 520), 3),
        (None, (1, 150), (-40, 41), 30),  # ragged: several buckets at once
    ],
    ids=["64x128", "128x64", "256x256", "512x1024", "ragged"],
)
def test_banded_pair_matches_gotoh_oracle(rng, bucket, la_range, d_range, n):
    """banded_pair_align (bucketing, padding, the XLA banded kernel and the
    device walk) against the full-matrix Gotoh oracle: scores exact, and
    each walked path scores the optimum."""
    from sarlacc_tpu.core.encode import encode_batch

    bw, sc = 6, dict(match=0.0, mismatch=-1.0, go=5.0, ge=1.0)
    seq_a, seq_b = _pair_case(rng, la_range, d_range, n)
    ca, la = encode_batch(seq_a)
    cb, lb = encode_batch(seq_b)
    la, lb = la.astype(np.int32), lb.astype(np.int32)
    d = lb.astype(np.int64) - la
    lo, hi = np.minimum(0, d) - bw, np.maximum(0, d) + bw
    if bucket is not None:
        rows_b = max(64, 1 << int(np.ceil(np.log2(la.max()))))
        w_b = max(64, 1 << int(np.ceil(np.log2((hi - lo + 1).max()))))
        assert (rows_b, w_b) == bucket and la.max() > rows_b // 2
    scores, paths = banded_pair_align(
        ca.astype(np.int32), la, cb.astype(np.int32), lb,
        match=sc["match"], mismatch=sc["mismatch"], gap_open=sc["go"],
        gap_ext=sc["ge"], bandwidth=bw,
    )
    for p in range(n):
        want = _gotoh_banded(seq_a[p], seq_b[p], int(lo[p]), int(hi[p]), **sc)
        assert scores[p] == want, (p, scores[p], want)
        ai, bi = paths[p]
        assert _path_score(seq_a[p], seq_b[p], ai, bi, **sc) == want, p



def test_pack_jmat_kernel(rng):
    """Device flat-packing of per-merge jmat row runs == direct slicing."""
    import jax.numpy as jnp

    from sarlacc_tpu.ops.msa import _pack_jmat_kernel

    rows, P = 128, 24
    jmat = rng.integers(0, 300, (rows, P)).astype(np.int16)
    las = rng.integers(1, rows + 1, P).astype(np.int64)
    starts = np.zeros(P + 1, np.int32)
    np.cumsum(las, out=starts[1:])
    T = int(starts[-1])
    Tb = ((T + 63) // 64) * 64
    flat = np.asarray(
        _pack_jmat_kernel(
            jnp.asarray(jmat), jnp.asarray(starts),
            jnp.asarray(np.arange(P, dtype=np.int32)), T=Tb,
        )
    )
    for m in range(P):
        np.testing.assert_array_equal(
            flat[starts[m] : starts[m] + las[m]], jmat[: las[m], m], err_msg=str(m)
        )


def test_merge_walk_emits_nothing_past_la(rng):
    """The packed merge readback (_run_merge_wave) keeps only the first
    ``la`` jmat rows per merge — sound only while the walk kernel never
    emits a match at a DP row beyond lens_a.  Pin that invariant on
    adversarial inputs (random direction planes, lens_a well below the row
    bucket) so a future walk change that breaks it fails loudly instead of
    silently truncating paths."""
    import jax.numpy as jnp

    from sarlacc_tpu.ops.msa import _merge_walk_kernel, _pair_walk_kernel

    rows, P, W = 64, 16, 32
    dirs = rng.integers(0, 3, (rows, P, W)).astype(np.int8)
    lens_a = rng.integers(1, rows // 2, P).astype(np.int32)
    lens_b = rng.integers(1, rows // 2, P).astype(np.int32)
    lo = (np.minimum(0, lens_b - lens_a) - 8).astype(np.int32)

    jmat = np.asarray(_merge_walk_kernel(jnp.asarray(dirs), lens_a, lens_b, lo))
    for p in range(P):
        assert not jmat[lens_a[p]:, p].any(), p

    # Same invariant for the Gotoh pair walk.  Its choice field must stay in
    # {0 diag, 1 horiz, 2 vert} — the DP kernel never emits 3, and the
    # walk's H-run resolve loop relies on that (a 3 would neither exit nor
    # move, spinning the while_loop forever), so the adversarial input here
    # randomizes only the legal encodings.
    choice = rng.integers(0, 3, (rows, P, W))
    dirs_g = (
        choice
        + (rng.integers(0, 2, (rows, P, W)) << 2)
        + (rng.integers(0, 2, (rows, P, W)) << 3)
    ).astype(np.int8)
    jmat_g = np.asarray(
        _pair_walk_kernel(jnp.asarray(dirs_g), lens_a, lens_b, lo)
    )
    for p in range(P):
        assert not jmat_g[lens_a[p]:, p].any(), p


def test_device_library_without_x64(rng):
    """Device vs host library parity in DEFAULT (32-bit) jax mode.

    The test suite enables x64 globally (float64 oracles), but the device
    runs 32-bit — an ``astype(int64)`` there silently truncates, which once
    zeroed the a-column of every packed device-library entry.  This
    regression test reruns the parity check in a subprocess without x64.
    """
    import subprocess
    import sys as _sys

    code = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
from sarlacc_tpu.api.msa import _build_library_device, _build_library_host

rng = np.random.default_rng(7)
n, L = 9, 120
codes = rng.integers(0, 4, (n, L)).astype(np.int8)
mut = rng.random((n, L)) < 0.1
codes[mut] = rng.integers(0, 4, int(mut.sum()))
lengths = rng.integers(100, L + 1, n).astype(np.int64)
by_group = [np.arange(4, dtype=np.int64), np.arange(4, 9, dtype=np.int64)]
args = (codes, lengths, by_group, [0, 1], 0.0, -1.0, 5.0, 1.0, 20)
libd, segd, _ = _build_library_device(*args)
libh, segh, _ = _build_library_host(*args)
tabd = np.asarray(libd[0]); tabh = np.asarray(libh[0])
assert set(segd) == set(segh), (sorted(segd), sorted(segh))
for k in segd:
    sd, sh = segd[k], segh[k]
    ed = tabd[sd[0]:sd[0]+sd[1]]; eh = tabh[sh[0]:sh[0]+sh[1]]
    assert ed.shape == eh.shape, (k, ed.shape, eh.shape)
    od = np.lexsort((ed[:,1], ed[:,0])); oh = np.lexsort((eh[:,1], eh[:,0]))
    ed, eh = ed[od], eh[oh]
    assert np.array_equal(ed[:, :2], eh[:, :2]), k
    assert np.abs(ed[:,2].astype(int) - eh[:,2].astype(int)).max() <= 1, k
print("OK")
"""
    env = dict(
        **{k: v for k, v in __import__("os").environ.items()},
    )
    env.pop("JAX_ENABLE_X64", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [_sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=env,
        cwd=__import__("os").path.dirname(
            __import__("os").path.dirname(__import__("os").path.abspath(__file__))
        ),
        timeout=300,
    )
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


def test_msa_deterministic(rng):
    ref = "".join(rng.choice(list("ACGT"), 150))
    seqs = noisy_copies(rng, ref, 6)
    batch = SeqBatch.from_strings(seqs, ["I" * len(s) for s in seqs])
    a = multi_read_align(batch, bandwidth=40)["alignments"][0]
    b = multi_read_align(batch, bandwidth=40)["alignments"][0]
    assert a == b


def test_device_library_matches_host_path(rng):
    """The on-device consistency library is bit-identical to the host
    (C++/NumPy) triplet-extension path: same pair segments, same (a, b)
    entries, weights within one uint16 quantum."""
    from sarlacc_tpu.api.msa import _build_library_device, _build_library_host

    ref1 = "".join(rng.choice(list("ACGT"), 160))
    ref2 = "".join(rng.choice(list("ACGT"), 220))
    seqs = noisy_copies(rng, ref1, 6) + noisy_copies(rng, ref2, 5)
    batch = SeqBatch.from_strings(seqs, ["I" * len(s) for s in seqs])
    groups = [np.arange(0, 6), np.arange(6, 11)]

    args = (batch.codes, batch.lengths, groups, [0, 1], 0.0, -1.0, 5.0, 1.0, 60)
    dev_lib, dev_seg, dev_id = _build_library_device(*args)
    host_lib, host_seg, host_id = _build_library_host(*args)

    for a, b in zip(dev_id, host_id):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert set(dev_seg) == set(host_seg)
    dev_tab = np.asarray(dev_lib[0])
    host_tab = np.asarray(host_lib[0])
    for key in sorted(host_seg):
        hs, hn = host_seg[key]
        ds, dn = dev_seg[key]
        assert hn == dn, key
        h = host_tab[hs : hs + hn]
        d = dev_tab[ds : ds + dn]
        np.testing.assert_array_equal(h[:, :2], d[:, :2], err_msg=str(key))
        assert np.abs(h[:, 2].astype(int) - d[:, 2].astype(int)).max(initial=0) <= 1


def test_device_lib_size_guard():
    """Groups with g-1 > 32 slots (or a huge entry table) must auto-route to
    the host library path (the extension kernel assumes SL <= 32)."""
    from sarlacc_tpu.api.msa import _device_lib_ok

    lengths = np.full(100, 200, np.int64)
    small = [np.arange(0, 8), np.arange(8, 20)]
    assert _device_lib_ok(lengths, small, [0, 1])
    big = [np.arange(0, 40)]  # g-1 = 39 -> SL bucket 64 > 32
    assert not _device_lib_ok(lengths, big, [0])
    # Table-size budget: many pairs of very long reads blow the byte budget.
    lengths_long = np.full(66, 60000, np.int64)
    wide = [np.arange(0, 33)]  # SL = 32 ok, but 528 pairs * 32 * 65536 * 6 B
    assert not _device_lib_ok(lengths_long, wide, [0])
