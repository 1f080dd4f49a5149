"""End-to-end adaptor pipeline tests (reference test-adaptor-align.R:142-212 +
test-tuning.R models): tempfile FASTQ round trips, strand flips, filtering,
realization, subsequence extraction, barcodes, and calibration."""

import os
import tempfile

import numpy as np
import pytest

import sarlacc_tpu as st
from sarlacc_tpu.api.tune import compute_threshold, tied_overlap
from sarlacc_tpu.core.encode import SeqBatch

ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "NNNNNNNN" + "CGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"


def _revcomp(s):
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


@pytest.fixture(scope="module")
def mock_fastq():
    fp = tempfile.mktemp(suffix=".fastq")
    refs, names = st.mock_reads(
        ADAPTOR1,
        ADAPTOR2,
        fp,
        nmolecules=3,
        nreads_range=(5, 9),
        seqlen_range=(120, 200),
        seed=3,
    )
    yield fp, refs
    os.remove(fp)


@pytest.fixture(scope="module")
def aligned(mock_fastq):
    fp, _ = mock_fastq
    return st.adaptor_align(ADAPTOR1, ADAPTOR2, filepath=fp, tolerance=80, number=50)


def test_adaptor_align_schema(aligned):
    assert aligned.colnames == ["read.width", "adaptor1", "adaptor2", "reversed"]
    a1 = aligned["adaptor1"]
    assert set(a1.colnames) == {"score", "start", "end", "subseq"}
    assert a1["subseq"].colnames == ["Sub1", "Sub2"]
    assert a1.metadata["sequence"] == ADAPTOR1
    assert aligned.metadata["tolerance"] == 80
    # Forward-strand adaptor2 coordinates are flipped (start > end).
    a2 = aligned["adaptor2"]
    assert np.all(a2["start"] >= a2["end"])


def test_strand_flip_consistency():
    # A read and its reverse complement give mirrored results
    # (test-adaptor-align.R:186-199).
    rng = np.random.default_rng(0)
    insert = "".join(rng.choice(list("ACGT"), 100))
    core = ADAPTOR1.replace("N", "A") + insert + _revcomp(ADAPTOR2)
    qual = "I" * len(core)
    fwd_and_rev = SeqBatch.from_strings(
        [core, _revcomp(core)], [qual, qual], names=["fwd", "rev"]
    )
    out = st.adaptor_align(ADAPTOR1, ADAPTOR2, reads=fwd_and_rev, tolerance=80)
    assert not out["reversed"][0] and out["reversed"][1]
    for col in ("score", "start", "end"):
        assert out["adaptor1"][col][0] == out["adaptor1"][col][1]
        assert out["adaptor2"][col][0] == out["adaptor2"][col][1]


def test_empty_input():
    out = st.adaptor_align(ADAPTOR1, ADAPTOR2, reads=SeqBatch.from_strings([], []))
    assert len(out) == 0
    assert out.colnames == ["read.width", "adaptor1", "adaptor2", "reversed"]


def test_inmemory_chunking_matches_unchunked(mock_fastq):
    """In-memory batches above ``number`` reads stream in chunks exactly
    like file input (an unchunked 500k batch OOMed the vignette-scale
    bench); results must be identical to the one-chunk run."""
    from sarlacc_tpu.io.fastq import read_fastq

    batch = read_fastq(mock_fastq[0])
    whole = st.adaptor_align(ADAPTOR1, ADAPTOR2, reads=batch, tolerance=80)
    chunked = st.adaptor_align(
        ADAPTOR1, ADAPTOR2, reads=batch, tolerance=80, number=7
    )
    assert len(whole) == len(chunked)
    assert np.array_equal(whole["reversed"], chunked["reversed"])
    for ad in ("adaptor1", "adaptor2"):
        for col in ("score", "start", "end"):
            assert np.allclose(
                np.asarray(whole[ad][col], float),
                np.asarray(chunked[ad][col], float),
            ), (ad, col)


def test_filter_and_realize(mock_fastq, aligned):
    fp, _ = mock_fastq
    thr = st.get_adaptor_thresholds(aligned, error=0.05)
    filtered = st.filter_reads(aligned, thr["threshold1"], thr["threshold2"])
    assert len(filtered) <= len(aligned)
    assert "trim.start" in filtered and "trim.end" in filtered
    assert np.all(filtered["trim.start"] < filtered["trim.end"])

    reads = st.realize_reads(filtered, number=50)
    assert len(reads) == len(filtered)
    # Trimmed width equals the trim interval.
    np.testing.assert_array_equal(
        reads.lengths, filtered["trim.end"] - filtered["trim.start"] + 1
    )

    # Non-essential adaptors keep everything.
    loose = st.filter_reads(aligned, 1e9, 1e9, essential1=False, essential2=False)
    assert len(loose) == len(aligned)


def test_extract_subseq_consistency(mock_fastq, aligned):
    fp, _ = mock_fastq
    out = st.extract_subseq(aligned, subseq1=([31], [38]), number=50)
    assert out["adaptor1"]["Sub1"].seq_strings() == (
        aligned["adaptor1"]["subseq"]["Sub2"].seq_strings()
    )


def test_barcode_align_and_thresholds(aligned):
    barcodes = ["AAAA", "CCCC", "GGGG", "TTTT"]
    bc = aligned["adaptor1"]["subseq"]["Sub1"]
    out = st.barcode_align(bc, barcodes)
    assert set(out.colnames) == {"barcode", "score", "gap"}
    assert np.all(out["gap"] >= 0)
    assert out.metadata["barcodes"] == barcodes
    thr = st.get_barcode_thresholds(out, nmads=3)
    assert thr["score"] <= np.median(out["score"])


def test_tied_overlap_units():
    # Unit cases (test-tuning.R:53-59).
    assert tied_overlap(np.array([2.0]), np.array([1.0])) == 1.0
    assert tied_overlap(np.array([0.0]), np.array([1.0])) == 0.0
    assert tied_overlap(np.array([1.0]), np.array([1.0])) == 0.5
    assert tied_overlap(np.array([1.0, 3.0]), np.array([0.0, 2.0])) == 0.75


def test_compute_threshold_basic():
    real = np.array([1.0, 2, 3, 4, 5, 6, 7, 8, 9, 10])
    scram = np.array([0.5, 1.5, 2.5])
    thr = compute_threshold(real, scram, error=0.1)
    # At threshold 3: 1 scrambled above? no — 0 above 3 of [0.5,1.5,2.5].
    assert thr <= 4.0


def test_tune_alignment_separates(mock_fastq):
    fp, _ = mock_fastq
    out = st.tune_alignment(
        ADAPTOR1,
        ADAPTOR2,
        filepath=fp,
        tolerance=60,
        number=20,
        gap_op_range=(4, 5),
        gap_ext_range=(1, 2),
    )
    assert out["parameters"]["gapOpening"] in (4, 5)
    # Real scores dominate scrambled ones on mock data.
    assert np.median(out["scores"]["reads"]) > np.median(out["scores"]["scrambled"])


def test_tune_empty_input():
    out = st.tune_alignment(
        ADAPTOR1, ADAPTOR2, reads=SeqBatch.from_strings([], []), number=5
    )
    assert out["parameters"]["gapOpening"] is None


def test_quality_align_oracle(rng):
    from sarlacc_tpu.refimpl.align import ReferenceAlign

    seqs, quals = [], []
    for _ in range(10):
        ln = int(rng.integers(5, 30))
        seqs.append("".join(rng.choice(list("ACGT"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(34, 70, ln)))
    ref = "ACGTACGTACGTGGCCA"
    out = st.quality_align(SeqBatch.from_strings(seqs, quals), ref)
    ra = ReferenceAlign(ref, 5, 1)
    for i in range(10):
        # The API path runs float32 on device; the reference's own tests use
        # 1e-4/1e-5 tolerances against Biostrings (test-adaptor-align.R:38-40).
        assert out["score"][i] == pytest.approx(
            ra.align(seqs[i], quals[i], local=False), abs=1e-4
        )
        assert out["query"][i].replace("-", "") == seqs[i]
        assert out["edit"][i] == sum(
            1 for a, b in zip(out["reference"][i], out["query"][i]) if a != b
        )


@pytest.mark.parametrize("qual_type", ["solexa", "illumina"])
def test_alternative_quality_encodings(qual_type):
    # The qual.type argument selects the error table end to end
    # (R/adaptorAlign.R:8, .qual2class).
    from sarlacc_tpu.core.quality import get_encoding
    from sarlacc_tpu.refimpl.align import ReferenceAlign

    enc = get_encoding(qual_type)
    q0 = chr(enc.offset + 5)
    seqs = ["ACGTACGTACGT"]
    quals = [q0 * 12]
    out = st.adaptor_align(
        "ACGTACGT", "TTTTCCCC", reads=SeqBatch.from_strings(seqs, quals),
        tolerance=12, qual_type=qual_type,
    )
    ra = ReferenceAlign("ACGTACGT", 5, 1, qual_type=qual_type)
    expect = ra.align(seqs[0], quals[0], local=True)
    got = max(out["adaptor1"]["score"][0], out["adaptor2"]["score"][0])
    # adaptor1 canonical orientation score must match the oracle
    assert out["adaptor1"]["score"][0] == pytest.approx(expect, abs=1e-4)


def test_dual_umi_end_to_end(mock_fastq):
    fp, _ = mock_fastq
    aligned = st.adaptor_align(ADAPTOR1, ADAPTOR2, filepath=fp, tolerance=80, number=50)
    bc = aligned["adaptor1"]["subseq"]["Sub1"]
    umi = aligned["adaptor1"]["subseq"]["Sub2"]
    groups = st.umi_group(umi, 3, bc, 2)
    flat = sorted(int(i) for g in groups for i in g)
    assert flat == list(range(len(aligned)))

def _reference_barcode_loop(seqs, quals, barcodes, go, ge):
    """The reference's sequential best/second-best walk over barcodes
    (R/barcodeAlign.R:27-38), scored by the float64 oracle.  Also returns
    the [B, n] per-barcode scores."""
    from sarlacc_tpu.refimpl.align import ReferenceAlign

    n = len(seqs)
    current = np.full(n, -np.inf)
    next_best = np.full(n, -np.inf)
    ids = np.full(n, -1, np.int64)
    per = []
    for b, bc in enumerate(barcodes):
        ra = ReferenceAlign(bc.upper(), go, ge)
        sc = np.asarray([ra.align(s, q, local=False) for s, q in zip(seqs, quals)])
        per.append(sc)
        better = sc > current
        next_best = np.where(better, current, np.maximum(next_best, sc))
        ids = np.where(better, b, ids)
        current = np.where(better, sc, current)
    return ids, current, next_best, np.stack(per)


def _observed_barcodes(rng, barcodes, n=40):
    """Barcode-region reads: noisy copies of the barcodes plus random ones."""
    seqs, quals = [], []
    for i in range(n):
        if i % 4 == 3:
            s = "".join(rng.choice(list("ACGT"), int(rng.integers(4, 15))))
        else:
            s = list(barcodes[int(rng.integers(0, len(barcodes)))])
            for _ in range(int(rng.integers(0, 3))):
                s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGTN")))
            s = "".join(s)
        seqs.append(s)
        quals.append("".join(chr(int(c)) for c in rng.integers(35, 75, len(s))))
    return seqs, quals


@pytest.mark.parametrize(
    "barcodes",
    [
        ["ACGTACGT", "TTGGCCAA", "GATCGATC", "CCCCAAAA"],
        # Duplicated barcode: an exact tie the first index must win.
        ["ACGTACGT", "TTGGCCAA", "ACGTACGT", "GGGGCCCC"],
        # The demux shape: twelve 12 bp barcodes.
        [
            "".join(np.random.default_rng(b).choice(list("ACGT"), 12))
            for b in range(12)
        ],
    ],
    ids=["distinct", "duplicate", "twelve"],
)
def test_barcode_align_matches_reference_loop(rng, barcodes):
    """barcode_align's device best/second-best (float32, one stacked
    readback) against the per-barcode float64 reference loop."""
    seqs, quals = _observed_barcodes(rng, barcodes)
    got = st.barcode_align(SeqBatch.from_strings(seqs, quals), barcodes)
    ids, best, second, per = _reference_barcode_loop(seqs, quals, barcodes, 5, 1)
    # float32 device sums against float64 oracle sums of ~12 cells.
    np.testing.assert_allclose(got["score"], best, rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        got["score"] - got["gap"], second, rtol=0, atol=1e-3
    )
    # Clear winners agree exactly; within float32 noise of a tie, the call
    # must still hold the best score.
    got_ids = np.asarray(got["barcode"])
    clear = (best - second) > 1e-3
    np.testing.assert_array_equal(got_ids[clear], ids[clear])
    assert (per[got_ids, np.arange(len(seqs))] >= best - 1e-3).all()
    # An exact tie (a duplicated barcode) goes to its first copy.
    dup = [b for b, bc in enumerate(barcodes) if barcodes.index(bc) != b]
    if dup:
        assert not clear.all() and not np.isin(got_ids, dup).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_tune_alignment_matches_reference_grid(mock_fastq, seed):
    """The device grid search (4 penalty points) against the same search
    scored by the float64 oracle (R/tuneAlignment.R:54-112)."""
    from sarlacc_tpu.api.align_internal import resolve_strand
    from sarlacc_tpu.api.tune import scramble_input
    from sarlacc_tpu.io.fastq import read_fastq
    from sarlacc_tpu.refimpl.align import ReferenceAlign

    fp, _ = mock_fastq
    reads = read_fastq(fp).take(np.arange(16))
    tol = 50
    got = st.tune_alignment(
        ADAPTOR1, ADAPTOR2, reads=reads, tolerance=tol, seed=seed,
        gap_op_range=(4, 5), gap_ext_range=(1, 2),
    )

    front, back = reads.front_and_back(tol)
    rng = np.random.default_rng(seed)
    sfront = scramble_input(front, rng)
    sback = scramble_input(back, rng)

    def four(ra1, ra2, f, b):
        fs, fq = f.seq_strings(), f.qual_strings()
        bs, bq = b.seq_strings(), b.qual_strings()
        return (
            np.asarray([ra1.align(s, q) for s, q in zip(fs, fq)]),
            np.asarray([ra2.align(s, q) for s, q in zip(bs, bq)]),
            np.asarray([ra1.align(s, q) for s, q in zip(bs, bq)]),
            np.asarray([ra2.align(s, q) for s, q in zip(fs, fq)]),
        )

    best_overlap, best_params, best_reads = 0.0, None, None
    for go in (4, 5):
        for ge in (1, 2):
            ra1 = ReferenceAlign(ADAPTOR1, go, ge)
            ra2 = ReferenceAlign(ADAPTOR2, go, ge)
            _, real = resolve_strand(*four(ra1, ra2, front, back))
            _, fake = resolve_strand(*four(ra1, ra2, sfront, sback))
            cur = tied_overlap(real, fake)
            if best_overlap < cur:
                best_overlap = cur
                best_params = {"gapOpening": go, "gapExtension": ge}
                best_reads = real
    assert got["parameters"] == best_params
    np.testing.assert_allclose(
        got["scores"]["reads"], best_reads, rtol=0, atol=1e-3
    )
