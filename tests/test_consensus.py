"""Consensus tests (reference test-consensus.R model): device kernels and API
against independent in-test oracles, curated N/gap cases, quality grids,
Phred round-trip, and the reference's error messages."""

import math

import numpy as np
import pytest

from sarlacc_tpu.api.consensus import consensus_read_seq
from sarlacc_tpu.core.quality import errors_to_phred_string, get_encoding
from sarlacc_tpu.refimpl.consensus import consensus_basic, consensus_quality

ENC = get_encoding("phred")


def basic_oracle(aln, min_cov, pseudo):
    """Independent tally oracle (test-consensus.R:21-42 style)."""
    width = len(aln[0])
    cons, errs = [], []
    for i in range(width):
        col = [a[i] for a in aln]
        present = [c for c in col if c != "-"]
        if len(present) < len(aln) * min_cov:
            continue
        counts = {b: sum(c == b for c in col) for b in "ACGT"}
        best = max("ACGT", key=lambda b: counts[b])
        total = sum(counts.values())
        errs.append(math.log1p(-(counts[best] + pseudo / 4) / (total + pseudo)))
        cons.append(best)
    return "".join(cons), np.asarray(errs)


def qual_oracle(aln, min_cov, quals):
    """Independent probabilistic oracle (test-consensus.R:92-138 style)."""
    width = len(aln[0])
    cons, errs = [], []
    for i in range(width):
        col = [a[i] for a in aln]
        present = sum(c != "-" for c in col)
        if present < len(aln) * min_cov:
            continue
        logp = {b: 0.0 for b in "ACGT"}
        for a, q in zip(aln, quals):
            pos = sum(1 for c in a[:i] if c != "-")
            c = a[i]
            if c in "-N":
                continue
            eps = min(max(ENC.to_error_scalar(q[pos]), 1e-8), 0.99999999)
            for b in "ACGT":
                logp[b] += math.log1p(-eps) if b == c else math.log(eps / 3)
        vals = np.asarray([logp[b] for b in "ACGT"])
        best = int(np.argmax(vals))
        cons.append("ACGT"[best])
        shifted = vals - vals.max()
        denom = np.log(np.exp(shifted).sum()) + vals.max()
        num = np.log(np.exp(np.delete(shifted, best)).sum()) + vals.max()
        errs.append(num - denom)
    return "".join(cons), np.asarray(errs)


CURATED = [
    ["ACGT", "ACGT", "ACGT"],
    ["AC-T", "ACGT", "A-GT"],
    ["NNNN", "ACGT", "ACGT"],
    ["AC-T", "NNGT", "A--T", "ACGT"],
    ["----", "ACGT", "ACGT"],
]


@pytest.mark.parametrize("aln", CURATED)
@pytest.mark.parametrize("min_cov,pseudo", [(0.6, 1.0), (0.0, 2.0), (1.0, 1.0)])
def test_basic_curated(aln, min_cov, pseudo):
    cons_r, errs_r = consensus_basic(aln, min_cov, pseudo)
    cons_o, errs_o = basic_oracle(aln, min_cov, pseudo)
    assert cons_r == cons_o
    np.testing.assert_allclose(errs_r, errs_o, atol=1e-12)
    out = consensus_read_seq([aln], pseudo_count=pseudo, min_coverage=min_cov)
    assert out.seq_strings()[0] == cons_o
    assert out.qual_strings()[0] == errors_to_phred_string(errs_o)


def test_quality_grid(rng):
    # Quality grids over error magnitudes (test-consensus.R:164-183).
    for rep in range(10):
        g = int(rng.integers(2, 8))
        w = int(rng.integers(4, 20))
        aln = []
        quals = []
        for _ in range(g):
            row = "".join(rng.choice(list("ACGT-N"), w, p=[0.2, 0.2, 0.2, 0.2, 0.15, 0.05]))
            aln.append(row)
            nbases = sum(c != "-" for c in row)
            quals.append("".join(chr(int(c)) for c in rng.integers(34, 70, nbases)))
        cons_r, errs_r = consensus_quality(aln, 0.4, quals, ENC)
        cons_o, errs_o = qual_oracle(aln, 0.4, quals)
        assert cons_r == cons_o
        np.testing.assert_allclose(errs_r, errs_o, atol=1e-9)
        out = consensus_read_seq([aln], min_coverage=0.4, qualities=[quals])
        assert out.seq_strings()[0] == cons_o
        assert out.qual_strings()[0] == errors_to_phred_string(errs_r)


def test_batch_consistency(rng):
    # Loop-vs-single consistency (test-consensus.R:71-88): many groups in one
    # call equal each group alone.
    groups, quals = [], []
    for _ in range(8):
        g = int(rng.integers(2, 6))
        w = int(rng.integers(4, 15))
        aln = ["".join(rng.choice(list("ACGT-"), w)) for _ in range(g)]
        groups.append(aln)
        quals.append(["I" * sum(c != "-" for c in a) for a in aln])
    many = consensus_read_seq(groups, qualities=quals)
    for i, (g, q) in enumerate(zip(groups, quals)):
        one = consensus_read_seq([g], qualities=[q])
        assert many.seq_strings()[i] == one.seq_strings()[0]
        assert many.qual_strings()[i] == one.qual_strings()[0]


def test_phred_roundtrip():
    # errorToPhred oracle (test-consensus.R:194-203).
    errs = np.log(np.asarray([0.5, 0.1, 1e-3, 1e-9, 1e-12]))
    s = errors_to_phred_string(errs)
    expect = [round(-10 * e / math.log(10)) for e in errs]
    expect = [min(v, 93) for v in expect]
    assert [ord(c) - 33 for c in s] == expect


def test_error_messages():
    with pytest.raises(ValueError, match="equal width"):
        consensus_read_seq([["ACGT", "ACG"]])
    with pytest.raises(ValueError, match="unknown character"):
        consensus_read_seq([["ACGX"]])
    with pytest.raises(ValueError, match="shorter than"):
        consensus_read_seq([["ACGT"]], qualities=[["III"]])
    with pytest.raises(ValueError, match="longer than"):
        consensus_read_seq([["ACGT"]], qualities=[["IIIII"]])
    with pytest.raises(ValueError, match="non-empty"):
        consensus_read_seq([[]])


def test_flat_matches_padded_path(rng, monkeypatch):
    """The flat device layout (uint8 stream + device gather + device Phred
    chars) must reproduce the padded/mesh layout byte-for-byte, both modes,
    across ragged widths, gaps, N and unknown chars."""
    groups, quals = [], []
    for g, w in [(2, 5), (7, 33), (3, 129), (16, 17), (1, 9), (4, 64)]:
        aln = ["".join(rng.choice(list("ACGT-N"), w)) for _ in range(g)]
        groups.append(aln)
        quals.append(
            [
                "".join(
                    chr(int(c)) for c in rng.integers(33, 90, sum(ch != "-" for ch in a))
                )
                for a in aln
            ]
        )
    flat_q = consensus_read_seq(groups, qualities=quals)
    flat_b = consensus_read_seq(groups)
    monkeypatch.setenv("SARLACC_CONSENSUS_PADDED", "1")
    pad_q = consensus_read_seq(groups, qualities=quals)
    pad_b = consensus_read_seq(groups)
    assert flat_q.seq_strings() == pad_q.seq_strings()
    assert flat_q.qual_strings() == pad_q.qual_strings()
    assert flat_b.seq_strings() == pad_b.seq_strings()
    assert flat_b.qual_strings() == pad_b.qual_strings()
