"""phylign-tpu: GPU-accelerated alignment of reads against the 661k bacterial genome collection.

A from-scratch JAX/XLA framework with the capabilities of
karel-brinda/Phylign (reference: /root/reference): a match -> filter -> align
workflow over phylogenetically-compressed genome batches.

Subsystems
----------
- ``phylign_tpu.io``       host IO: FASTA/FASTQ, COBS classic indexes, assembly
                           tarballs, SAM emission/aggregation, stats.
- ``phylign_tpu.kmer``     2-bit DNA encoding, canonical k-mers, XXH64 hashing.
- ``phylign_tpu.ops``      JAX device kernels: bit-matrix popcount match,
                           top-k filtering, minimizers, chaining, banded align.
- ``phylign_tpu.models``   flagship jittable "models": Matcher (k-mer
                           containment scoring) and Aligner (seed-chain-extend).
- ``phylign_tpu.match``    match stage orchestration (COBS-compatible scoring,
                           postprocess/filter tie semantics).
- ``phylign_tpu.align``    alignment stage orchestration and SAM emission.
- ``phylign_tpu.parallel`` device meshes, sharded match, distributed top-k.
- ``phylign_tpu.pipeline`` end-to-end pipeline: stages, resource-aware
                           scheduler, checkpoint/resume manifest, download.
- ``phylign_tpu.utils``    benchmarking/logging contract (logs/benchmarks/...).
"""

from phylign_tpu.version import __version__

__all__ = ["__version__"]
