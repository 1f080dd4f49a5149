"""Host-side profile of the symmetric-delete UMI grouping path.

Usage: python scripts/profile_umi_host.py [n_umis] [umi_len] [n_clusters]
Times each stage of umi_group's large-n path on synthetic data shaped like
the bench's umi_1m config.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    ncl = int(sys.argv[3]) if len(sys.argv) > 3 else n // 5

    rng = np.random.default_rng(9)
    centers = rng.integers(0, 4, (ncl, L)).astype(np.int8)
    assign = rng.integers(0, ncl, n)
    codes = centers[assign].copy()
    mut = rng.random((n, L)) < 0.08
    codes[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.int8)
    lengths = np.full(n, L, np.int64)

    t0 = time.perf_counter()
    u_codes, first_idx, inv, cnt = np.unique(
        codes, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    t1 = time.perf_counter()
    print(f"unique: {t1-t0:.2f}s ({u_codes.shape[0]} unique of {n})")

    from sarlacc_tpu.ops.levenshtein import (
        _delete_variant_entries,
        _neighbor_pairs_filtered,
    )

    u_lens = lengths[first_idx].astype(np.int32)
    t0 = time.perf_counter()
    h, owner = _delete_variant_entries(u_codes, u_lens, 2)
    t1 = time.perf_counter()
    print(f"variants: {t1-t0:.2f}s ({h.size} entries)")

    from sarlacc_tpu.native import sym_delete_verify_native

    t0 = time.perf_counter()
    fused = sym_delete_verify_native(
        u_codes, u_lens, 2, 2, 2 * 2, raw_cap=1 << 31
    )
    t1 = time.perf_counter()
    print(f"fused sym-delete+verify: {t1-t0:.2f}s ({None if fused is None else fused.size} pairs)")

    t0 = time.perf_counter()
    res = _neighbor_pairs_filtered(u_codes.astype(np.int32), u_lens, 2, 4)
    t1 = time.perf_counter()
    print(f"_neighbor_pairs_filtered total: {t1-t0:.2f}s")

    # Full umi_group for reference.
    from sarlacc_tpu.core.encode import SeqBatch
    import sarlacc_tpu as st

    CODE = np.array(list("ACGTN"))
    seqs = ["".join(r) for r in CODE[codes]]
    batch = SeqBatch.from_strings(seqs)
    t0 = time.perf_counter()
    out = st.umi_group(batch, threshold1=2)
    t1 = time.perf_counter()
    print(f"umi_group total: {t1-t0:.2f}s ({len(out)} groups)")


if __name__ == "__main__":
    main()
