"""Consensus stage split: encode / pack / dispatch / readback / assemble.

Builds a bench-shaped MSA workload (n groups x ~10 members x ~550-col
alignments with qualities), runs ``consensus_read_seq`` once for compile,
then reports the profiler's per-stage wall split for a timed pass.

Usage: python scripts/profile_consensus.py [ngroups] [--padded]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sarlacc_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()


def build(ngroups: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    groups, quals = [], []
    for _ in range(ngroups):
        g = int(rng.integers(2, 17))
        w = int(rng.integers(420, 700))
        aln = []
        for _ in range(g):
            chars = rng.choice(list("ACGT"), w)
            gaps = rng.random(w) < 0.08
            chars[gaps] = "-"
            aln.append("".join(chars))
        groups.append(aln)
        quals.append(
            [
                "".join(chr(int(c)) for c in rng.integers(35, 75, sum(ch != "-" for ch in a)))
                for a in aln
            ]
        )
    return groups, quals


def main():
    ngroups = int(sys.argv[1]) if len(sys.argv) > 1 else 950
    if "--padded" in sys.argv:
        os.environ["SARLACC_CONSENSUS_PADDED"] = "1"
    groups, quals = build(ngroups)

    from sarlacc_tpu.api.consensus import consensus_read_seq
    from sarlacc_tpu.utils.profiling import PipelineProfiler, set_profiler

    consensus_read_seq(groups, qualities=quals)  # warmup/compile

    prof = PipelineProfiler()
    set_profiler(prof)
    t0 = time.time()
    out = consensus_read_seq(groups, qualities=quals)
    dt = time.time() - t0
    mode = "padded" if os.environ.get("SARLACC_CONSENSUS_PADDED") else "flat"
    print(f"consensus[{mode}] {ngroups} groups: {dt:.3f} s total "
          f"({ngroups / dt:.0f} groups/s), {len(out)} consensi")
    print(prof.report())


if __name__ == "__main__":
    main()
