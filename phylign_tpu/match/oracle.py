"""Slow-but-obviously-correct numpy reference for the match stage.

This is the parity oracle the device kernels are tested against (the real
``cobs`` binary and Zenodo indexes are unreachable in this environment; this
module plays the role the golden intermediates play in the reference's test
strategy, SURVEY.md section 4).

Scoring contract (cobs 0.2.1 classic search as used at
/root/reference/Snakefile:419-427):
  * For each of the query's L-k+1 k-mer positions, the canonical k-mer picks
    ``num_hashes`` Bloom rows; the k-mer "hits" document d iff d's bit is set
    in ALL selected rows.
  * score(q, d) = number of k-mer positions that hit d (positions are NOT
    deduplicated).
  * A document is reported iff score >= threshold * (L-k+1)
    (``-t {cobs_kmer_thres}``, default 0.7: /root/reference/config.yaml:20).
  * Output is sorted by score descending, ties by document name ascending —
    the 661k doc names embed a random prefix, making tie order randomized
    but deterministic (ref: postprocess_cobs.py:16-18).
"""

from __future__ import annotations

import numpy as np

from phylign_tpu.io.cobs import DeviceIndex
from phylign_tpu.kmer import cobs_row_indices


def score_query_codes(
    didx: DeviceIndex, codes: np.ndarray
) -> tuple[np.ndarray, int]:
    """Scores of one query against every doc. Returns (scores[int32, D], n_kmers)."""
    k = didx.term_size
    rows = cobs_row_indices(codes, k, didx.signature_size, didx.num_hashes)
    n_kmers = rows.shape[0]
    d = didx.num_docs
    scores = np.zeros(d, dtype=np.int32)
    if n_kmers == 0:
        return scores, 0
    words = np.asarray(didx.words)
    doc_idx = np.arange(d)
    w_idx, b_idx = doc_idx // 32, doc_idx % 32
    for p in range(n_kmers):
        hit = np.ones(d, dtype=bool)
        for h in range(didx.num_hashes):
            row = words[rows[p, h]]
            hit &= ((row[w_idx] >> b_idx) & 1).astype(bool)
        scores += hit
    return scores, n_kmers


def query_index(
    didx: DeviceIndex, codes: np.ndarray, threshold: float
) -> list[tuple[str, int]]:
    """All (doc_name, score) passing the threshold, in cobs output order."""
    scores, n_kmers = score_query_codes(didx, codes)
    keep = scores >= threshold * n_kmers if n_kmers > 0 else scores > 0
    hits = [(didx.doc_names[d], int(scores[d])) for d in np.nonzero(keep)[0]]
    hits.sort(key=lambda x: (-x[1], x[0]))
    return hits
