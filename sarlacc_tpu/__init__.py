"""sarlacc_tpu — UMI-based long-read error correction on accelerators.

A ground-up JAX/XLA re-design of the capabilities of the
MarioniLab/sarlacc Bioconductor package: quality-aware adaptor and barcode
alignment, UMI grouping by masked Levenshtein distance, multiple sequence
alignment per UMI group, and position-wise consensus calling with
Phred-quality output — built for batched execution on GPUs and device meshes.

Layer map:

* ``core``     — encodings, quality tables, batch containers, result frames
* ``refimpl``  — slow, exact NumPy oracles transcribing the reference C++
* ``ops``      — batched JAX/XLA device kernels
* ``parallel`` — mesh construction and sharded execution
* ``io``       — FASTQ/SAM streaming, read simulator
* ``api``      — the pipeline operations (adaptor_align .. consensus_read_seq)
"""

from .api import *  # noqa: F401,F403
from .api import __all__ as _api_all

__all__ = list(_api_all)
__version__ = "0.1.0"
