"""Device DP aligner vs the exact oracle (reference test-adaptor-align.R model).

Scores must agree to float tolerance; backtrack products must either match
the oracle exactly or be co-optimal (degapped reconstruction + recomputed
score equality), mirroring how the reference tests tolerate Biostrings'
co-optimal paths (test-adaptor-align.R:38-40, test-general-align.R:17-53).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sarlacc_tpu.core.encode import SeqBatch
from sarlacc_tpu.ops.align import dp_align, prepare_reads, prepare_reference
from sarlacc_tpu.ops.backtrack import backtrack_map, backtrack_strings
from sarlacc_tpu.refimpl.align import ReferenceAlign
from sarlacc_tpu.core.scoring import build_score_tables

ADAPTOR = "ACGATCAGCTAGNNNNNCGACTAGCTAGCTAG"


def _random_batch(rng, n=20, minlen=5, maxlen=60):
    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(minlen, maxlen))
        seqs.append("".join(rng.choice(list("ACGT"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(34, 75, ln)))
    return seqs, quals


def _run(seqs, quals, adaptor=ADAPTOR, go=5.0, ge=1.0, local=True):
    tables = build_score_tables("phred")
    batch = SeqBatch.from_strings(seqs, quals)
    codes, qidx, lengths = prepare_reads(batch, tables)
    modes, matched, mt, mmt = prepare_reference(adaptor, tables, dtype=jnp.float64)
    scores, dirs = dp_align(
        codes, qidx, lengths, modes, matched, mt, mmt, go, ge,
        local=local, need_directions=True,
    )
    return np.asarray(scores), np.asarray(dirs)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("go,ge", [(5, 1), (4, 2), (8, 3)])
def test_scores_match_oracle(rng, local, go, ge):
    seqs, quals = _random_batch(rng)
    scores, _ = _run(seqs, quals, go=float(go), ge=float(ge), local=local)
    ra = ReferenceAlign(ADAPTOR, go, ge)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        assert scores[i] == pytest.approx(ra.align(s, q, local=local), abs=1e-9)


@pytest.mark.parametrize("local", [True, False])
def test_backtrack_products(rng, local):
    seqs, quals = _random_batch(rng)
    scores, dirs = _run(seqs, quals, local=local)
    ra = ReferenceAlign(ADAPTOR, 5, 1)
    exact = 0
    for i, (s, q) in enumerate(zip(seqs, quals)):
        ra.align(s, q, local=local)
        rstr_o, qstr_o = ra.fill_strings(s)
        rstr_d, qstr_d = backtrack_strings(
            dirs[:, i, : len(s) + 1], len(ADAPTOR), ADAPTOR, s
        )
        # Degapped reconstruction always holds.
        assert qstr_d.replace("-", "") == s
        assert rstr_d.replace("-", "") == ADAPTOR
        assert len(rstr_d) == len(qstr_d)
        if (rstr_o, qstr_o) == (rstr_d, qstr_d):
            exact += 1
    # Co-optimal divergence is rare: the overwhelming majority must be exact.
    assert exact >= len(seqs) - 3


def test_empty_read_and_adaptor():
    # Empty read: all-left path costs -(len + gapOpening)
    # (test-adaptor-align.R:48-56).
    scores, dirs = _run([""], [""])
    assert scores[0] == -(len(ADAPTOR) + 5)
    qm = backtrack_map(dirs[:, 0, :1], len(ADAPTOR))
    s, e = qm(0, len(ADAPTOR))
    assert s == e

    tables = build_score_tables("phred")
    batch = SeqBatch.from_strings(["ACGT"], ["IIII"])
    codes, qidx, lengths = prepare_reads(batch, tables)
    modes, matched, mt, mmt = prepare_reference("", tables, dtype=jnp.float64)
    scores, _ = dp_align(
        codes, qidx, lengths, modes, matched, mt, mmt, 5.0, 1.0,
        local=True, need_directions=False,
    )
    assert np.asarray(scores)[0] == 0.0


def test_full_adaptor_window_covers_read(rng):
    # .align_and_extract with the full adaptor range returns the whole read
    # (test-adaptor-align.R:119-121).
    seqs, quals = _random_batch(rng, n=10)
    _, dirs = _run(seqs, quals)
    for i, s in enumerate(seqs):
        qm = backtrack_map(dirs[:, i, : len(s) + 1], len(ADAPTOR))
        assert qm(0, len(ADAPTOR), include_gaps=True) == (0, len(s))


def test_query_maps_match_oracle(rng):
    seqs, quals = _random_batch(rng, n=15)
    _, dirs = _run(seqs, quals)
    ra = ReferenceAlign(ADAPTOR, 5, 1)
    agree = 0
    for i, (s, q) in enumerate(zip(seqs, quals)):
        ra.align(s, q, local=True)
        qm_o = ra.fill_map()
        qm_d = backtrack_map(dirs[:, i, : len(s) + 1], len(ADAPTOR))
        if qm_o.mapping == qm_d.mapping:
            agree += 1
        # Window queries must at least produce valid, ordered spans.
        s0, e0 = qm_d(0, len(ADAPTOR))
        assert 0 <= s0 <= e0 <= len(s)
    assert agree >= 13


ADAPTOR47 = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT"
BARCODE = "ACGTTGCACGTA"


def _device_inputs(rng, ref, n=37, minl=0, maxl=60):
    """Reads with N bases, at the precision the device runs: float32 score
    tables, as ``prepare_adaptor`` builds them."""
    from sarlacc_tpu.api.align_internal import prepare_adaptor

    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(minl, maxl + 1))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(35, 90, ln)))
    ad = prepare_adaptor(ref)
    codes, qidx, lengths = prepare_reads(SeqBatch.from_strings(seqs, quals), ad.tables)
    return seqs, quals, ad, (codes, qidx, lengths)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("go,ge", [(5.0, 1.0), (2.0, 3.0)])
@pytest.mark.parametrize("ref", [ADAPTOR47, BARCODE], ids=["adaptor", "barcode"])
def test_float32_scores_match_oracle(rng, ref, go, ge, local):
    seqs, quals, ad, (codes, qidx, lengths) = _device_inputs(rng, ref)
    scores, _ = dp_align(
        codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab,
        ad.mismatch_tab, go, ge, local=local, need_directions=False,
    )
    assert scores.dtype == jnp.float32
    ra = ReferenceAlign(ref, go, ge)
    want = [ra.align(s, q, local=local) for s, q in zip(seqs, quals)]
    # float32 sums of log-quality costs against float64 ones, over at most
    # ~100 cells per read.
    np.testing.assert_allclose(np.asarray(scores), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("minl,maxl", [(0, 40), (40, 120)], ids=["short", "long"])
def test_device_walk_query_maps_match_oracle(rng, minl, maxl):
    """qmap_walk_device's maps against the reference walk; co-optimal
    divergence from float32 tie-breaks is tolerated, as the reference's own
    tests tolerate Biostrings' (test-adaptor-align.R:38-40)."""
    from sarlacc_tpu.ops.backtrack import qmap_walk_device

    seqs, quals, ad, (codes, qidx, lengths) = _device_inputs(
        rng, ADAPTOR47, n=24, minl=minl, maxl=maxl
    )
    _, dirs = dp_align(
        codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab,
        ad.mismatch_tab, 5.0, 1.0, local=True, need_directions=True,
    )
    is_match, dp_row = (np.asarray(x) for x in qmap_walk_device(dirs, lengths))
    ra = ReferenceAlign(ADAPTOR47, 5, 1)
    agree = 0
    for i, (s, q) in enumerate(zip(seqs, quals)):
        ra.align(s, q, local=True)
        want = ra.fill_map().mapping
        got = list(zip(is_match[i].tolist(), dp_row[i].tolist()))
        agree += got == [(bool(m), int(r)) for m, r in want]
    assert agree >= len(seqs) - 2
