"""Matcher: the flagship match-stage model.

Wraps one batch's packed Bloom bit-matrix as device state and exposes a
jittable scoring step: (row_idx, n_kmers) -> (scores, keep mask). This is
the device equivalent of one ``cobs query`` invocation against one batch
index (ref: /root/reference/Snakefile:419-427), minus the text postprocessing
which stays on host (phylign_tpu.match.postprocess).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from phylign_tpu.io.cobs import DeviceIndex
from phylign_tpu.kmer import cobs_row_indices, encode_seq
from phylign_tpu.ops.match import (
    dedup_rows,
    match_scores_xla,
    match_scores_xla_dedup,
    pack_row_indices,
    pad_device_words,
    round_up,
)


@functools.partial(jax.jit, static_argnames=("d_pad", "dtype"))
def _compact_scores(scores: jax.Array, d_pad: int, dtype) -> jax.Array:
    """Device-side transfer compaction: drop padding doc columns and downcast
    before D2H. Slicing to the real doc count and casting to the smallest
    dtype that can hold the max possible score (the per-segment k-mer count)
    cuts the fetched bytes 4-5x vs the raw [Q, 32*Wp] int32 matrix.
    d_pad is rounded up by the caller to bound distinct compile shapes."""
    return scores[:, :d_pad].astype(dtype)


@functools.partial(jax.jit, static_argnames=("kk", "d"))
def _topk_scores(
    scores: jax.Array, cut: jax.Array, kk: int, d: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Device-side threshold + top-k: returns (vals u16 [Q, kk],
    idx u16 [Q, kk], n_keep i32 [Q]).

    ``cut`` is the per-query integer threshold (int32 [Q]; smallest integer
    score that qualifies, computed on HOST in float64 so boundary hits match
    the full-matrix path bit-for-bit — a float32 device cut diverges at
    exact-threshold scores). Docs with score >= cut survive (others come
    back as val 0 / idx 0 with n_keep bounding the real count). When
    n_keep[q] > kk the caller must re-fetch that query's full row — the
    top-k window missed ties. Fetches ~5x fewer bytes than the full matrix."""
    s = scores[:, :d].astype(jnp.int32)
    ok = s >= cut[:, None]
    masked = jnp.where(ok, s, -1)
    vals, idx = jax.lax.top_k(masked, kk)
    n_keep = ok.sum(axis=1, dtype=jnp.int32)
    keep = vals >= 0
    return (
        jnp.where(keep, vals, 0).astype(jnp.uint16),
        jnp.where(keep, idx, 0).astype(jnp.uint16),
        n_keep,
    )


def _rows_from_hashes_dev(hi: jax.Array, lo: jax.Array, s: int) -> jax.Array:
    """Bloom row ``(hi*2^32 + lo) % s`` elementwise in uint32-only ops.

    The raw XXH64 hash is device-resident as two u32 words (JAX's x64 flag is
    process-global and racy under scheduler threads, so the device code
    stays in 32-bit integers). With ``s`` static (< 2^31 — cobs signature sizes are
    far below), ``(hi * 2^32) % s`` unrolls into 32 conditional adds of the
    compile-time constants ``2^(32+k) % s`` with a subtract-reduce keeping
    every intermediate < 2s < 2^32. Exact for all inputs; verified against
    numpy uint64 in tests/test_match_dedup.py."""
    su = jnp.uint32(s)
    x = lo % su
    one = jnp.uint32(1)
    zero = jnp.uint32(0)
    for k in range(32):
        bk = (1 << (32 + k)) % s
        if bk == 0:
            continue
        add = jnp.where((hi >> jnp.uint32(k)) & one != zero, jnp.uint32(bk), zero)
        x = x + add
        x = jnp.where(x >= su, x - su, x)
    return x


@functools.partial(jax.jit, static_argnames=("s", "pad_row", "kk", "d"))
def _hash_topk(
    words: jax.Array,
    hi: jax.Array,
    lo: jax.Array,
    nk: jax.Array,
    cut: jax.Array,
    *,
    s: int,
    pad_row: int,
    kk: int,
    d: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Mod -> gather/popcount -> threshold+top-k as ONE device program over
    device-RESIDENT raw query hashes: per batch only the [Q] cut vector and
    the [Q, kk] hit window cross the link, not a [Q, K] row-index upload
    (the reference re-runs `cobs query` per batch, re-reading the queries
    305 times; Snakefile:419-427)."""
    rows = _rows_from_hashes_dev(hi, lo, s).astype(jnp.int32)  # [Q, K, H]
    col = jnp.arange(hi.shape[1], dtype=jnp.int32)
    rows = jnp.where(col[None, :, None] < nk[:, None, None], rows, pad_row)
    scores = match_scores_xla(words, rows)
    return _topk_scores(scores, cut, kk, d)


@functools.partial(
    jax.jit, static_argnames=("s", "pad_row", "kk", "d", "cap")
)
def _hash_topk_flat(
    words: jax.Array,
    hi: jax.Array,
    lo: jax.Array,
    nk: jax.Array,
    cut: jax.Array,
    *,
    s: int,
    pad_row: int,
    kk: int,
    d: int,
    cap: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """_hash_topk with the hit window COMPACTED on device: qualifying
    (score u16 | doc u16) pairs pack into one flat u32 buffer of the
    queries' take counts (take = min(n_keep, kk)), so the D2H fetch moves
    only real hits instead of the dense [Q, kk] window — with the default
    nb_best_hits and a typical few-hit query that is ~10x fewer bytes
    fetched. Returns ONE u32 array [cap hits | Q n_keep | total] so the
    fetch is a single transfer; total > cap signals scatter overflow
    (caller refetches the dense window)."""
    rows = _rows_from_hashes_dev(hi, lo, s).astype(jnp.int32)
    col = jnp.arange(hi.shape[1], dtype=jnp.int32)
    rows = jnp.where(col[None, :, None] < nk[:, None, None], rows, pad_row)
    scores = match_scores_xla(words, rows)
    vals, idx, n_keep = _topk_scores(scores, cut, kk, d)
    take = jnp.minimum(n_keep, kk)
    off = jnp.cumsum(take) - take
    colk = jnp.arange(kk, dtype=jnp.int32)
    pos = off[:, None] + colk[None, :]
    valid = colk[None, :] < take[:, None]
    packed = (vals.astype(jnp.uint32) << jnp.uint32(16)) | idx.astype(
        jnp.uint32
    )
    # ONE output array: [cap hit words | Q n_keep | 1 total] — a single
    # device_get conversion
    out = (
        jnp.zeros((cap + hi.shape[0] + 1,), jnp.uint32)
        .at[jnp.where(valid, pos, cap + hi.shape[0] + 1)]
        .set(packed, mode="drop")
    )
    out = out.at[cap : cap + hi.shape[0]].set(n_keep.astype(jnp.uint32))
    return out.at[cap + hi.shape[0]].set(take.sum().astype(jnp.uint32))


@dataclass
class DeviceQueryHashes:
    """One query chunk's raw k-mer hashes, resident on device.

    Uploaded ONCE per read set (kmer.cobs_kmer_hashes output split into u32
    halves) and reused by every batch's Matcher — the per-batch
    ``% signature_size`` runs on device inside _hash_topk. ``raw`` keeps the
    host copy for the fallback paths (segmented queries, huge doc counts,
    top-k window overflow re-fetch)."""

    hi: jax.Array  # uint32 [Q_pad, K, H] (query axis q_bucket-padded)
    lo: jax.Array  # uint32 [Q_pad, K, H]
    n_kmers: np.ndarray  # int32 [Q_pad] host (padding rows = 0)
    raw: list[np.ndarray]  # per-query uint64 [n, H] host (REAL queries only)
    q_real: int = -1  # real query count (<= Q_pad); results slice to this
    # device-resident twins, uploaded once per chunk: nk is constant, and
    # the integer cut vector depends only on (nk, threshold) — NOT on the
    # batch — so neither needs a per-batch H2D round trip
    _nk_dev: jax.Array | None = None
    _cut_dev: dict | None = None

    def nk_dev(self) -> jax.Array:
        if self._nk_dev is None:
            object.__setattr__(self, "_nk_dev", jax.device_put(self.n_kmers))
        return self._nk_dev

    def cut_dev(self, threshold: float) -> jax.Array:
        if self._cut_dev is None:
            object.__setattr__(self, "_cut_dev", {})
        hit = self._cut_dev.get(threshold)
        if hit is None:
            hit = jax.device_put(_int_cut(threshold, self.n_kmers))
            self._cut_dev[threshold] = hit
        return hit

    @classmethod
    def build(
        cls, raw: list[np.ndarray], k_bucket: int = 64, q_bucket: int = 1024
    ) -> "DeviceQueryHashes":
        """``q_bucket`` pads the query axis so read sets of similar size
        share compiled device programs (Q is a static shape: an unpadded Q
        would re-jit every per-batch program for every new read set).
        Padding rows carry nk=0, whose _int_cut is unreachable — they can
        never emit hits, and callers slice results back to q_real."""
        q_real = len(raw)
        qp = round_up(max(1, q_real), q_bucket)
        nk = np.zeros(qp, np.int32)
        nk[:q_real] = [r.shape[0] for r in raw]
        h = raw[0].shape[1] if raw else 1
        kp = round_up(int(nk.max(initial=1)), k_bucket)
        hi = np.zeros((qp, kp, h), np.uint32)
        lo = np.zeros((qp, kp, h), np.uint32)
        if raw:
            # one concatenate + one 2-D scatter (a python loop over tens of
            # thousands of reads costs ~0.3 s per query set)
            cat = np.concatenate(raw)
            lens = nk.astype(np.int64)  # padded rows repeat 0 times
            rows = np.repeat(np.arange(qp), lens)
            cols = np.arange(len(cat)) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            hi[rows, cols] = (cat >> np.uint64(32)).astype(np.uint32)
            lo[rows, cols] = (cat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi_d, lo_d = jax.device_put((hi, lo))  # one batched H2D round trip
        return cls(hi=hi_d, lo=lo_d, n_kmers=nk, raw=raw, q_real=q_real)

    @property
    def nbytes(self) -> int:
        return int(self.hi.size + self.lo.size) * 4


def _int_cut(threshold: float, n_kmers: np.ndarray) -> np.ndarray:
    """Smallest integer score satisfying ``score >= threshold * n`` in
    float64 (the host/reference comparison), per query. Queries with no
    k-mers get an impossible cut so they can never match."""
    t = np.float64(threshold) * n_kmers.astype(np.float64)
    cut = np.ceil(t).astype(np.int64)
    # ceil gives the right integer except when t is itself integral (ceil
    # keeps it) — i.e. cut >= t by construction; but guard float error:
    cut = np.where(cut.astype(np.float64) < t, cut + 1, cut)
    cut = np.where(n_kmers > 0, np.maximum(cut, 0), np.int64(1 << 30))
    return cut.astype(np.int32)


@jax.jit
def match_step(
    words: jax.Array,
    row_idx: jax.Array,
    n_kmers: jax.Array,
    threshold: float,
) -> tuple[jax.Array, jax.Array]:
    """One scoring step: scores [Q, 32*Wp] int32 and keep mask [Q, 32*Wp].

    keep[q, d] = score >= threshold * n_kmers[q]  (cobs -t semantics,
    ref: /root/reference/config.yaml:20). Callers slice [:, :num_docs].
    """
    scores = match_scores_xla(words, row_idx)
    cut = threshold * n_kmers.astype(jnp.float32)
    keep = scores.astype(jnp.float32) >= cut[:, None]
    keep = jnp.logical_and(keep, n_kmers[:, None] > 0)
    return scores, keep


def _lane_words(mesh) -> int:
    """Word-column multiple of the uploaded matrix: exact width on one
    device; with a mesh, every doc shard needs equal 8-word-aligned
    columns."""
    return 1 if mesh is None else 8 * mesh.shape["d"]


def device_index_bytes(didx: DeviceIndex, mesh=None) -> int:
    """Exact device footprint of the padded word matrix an index will occupy
    once uploaded (mirrors from_device_index's padding choice). Used by the
    pipeline's device-memory accountant to admit overlapping index
    uploads."""
    wp = round_up(max(didx.num_words, 1), _lane_words(mesh))
    return (didx.signature_size + 1) * wp * 4


@dataclass
class Matcher:
    """Device-resident match model for one batch index.

    With a mesh (multi-chip), the word-column axis is sharded over the mesh's
    doc axis and scoring runs via parallel.dist with zero communication;
    row-index inputs are sharded over the query axis.
    """

    term_size: int
    num_hashes: int
    signature_size: int
    doc_names: list[str]
    words: jax.Array  # uint32 [S+1, Wp] on device
    mesh: object | None = None  # jax.sharding.Mesh or None
    #: cross-query k-mer dedup (two-stage gather, ops.match.dedup_rows).
    #: Can beat the big-table gather when many of a chunk's row indices
    #: repeat (overlapping/high-coverage reads) — but it adds a host-side
    #: unique pass, so it is opt-in: enable where that pass is cheaper than
    #: the device time it saves. Scores are bit-identical either way
    #: (tested).
    dedup: bool = False

    def _device_scores(self, packed: np.ndarray) -> jax.Array:
        """Score one packed chunk, via the dedup path when enabled+profitable."""
        if self.dedup and self.mesh is None:
            dd = dedup_rows(packed, self.pad_row, self.words.shape[1])
            if dd is not None:
                return match_scores_xla_dedup(
                    self.words, jnp.asarray(dd[0]), jnp.asarray(dd[1])
                )
        return match_scores_xla(self.words, jnp.asarray(packed))

    @classmethod
    def from_device_index(cls, didx: DeviceIndex, mesh=None) -> "Matcher":
        padded = pad_device_words(
            np.asarray(didx.words), lane_words=_lane_words(mesh)
        )
        if mesh is None:
            words = jnp.asarray(padded)
        else:
            from jax.sharding import PartitionSpec as P

            from phylign_tpu.parallel.dist import global_array
            from phylign_tpu.parallel.mesh import AXIS_DOC

            # global array: single-process this is a sharded device_put;
            # multi-process (jax.distributed) each host uploads only its
            # own doc-column shards
            words = global_array(mesh, padded, P(None, AXIS_DOC))
        return cls(
            term_size=didx.term_size,
            num_hashes=didx.num_hashes,
            signature_size=didx.signature_size,
            doc_names=didx.doc_names,
            words=words,
            mesh=mesh,
        )

    @property
    def pad_row(self) -> int:
        return self.words.shape[0] - 1

    def rows_for_queries(
        self, seqs: list[bytes], k_max: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side k-mer extraction + hashing for a query batch."""
        per_query = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return pack_row_indices(per_query, k_max, self.pad_row, self.num_hashes)

    def score(
        self, seqs: list[bytes], threshold: float, k_max: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Convenience host API: returns (scores[Q, D], keep[Q, D], n_kmers[Q]).

        Queries longer than k_max+term_size-1 are split into k_max-k-mer
        segments scored as separate device rows and summed — exact for any
        query length with fixed device shapes.
        """
        per_query = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return self.score_rows(per_query, threshold, k_max)

    def score_rows(
        self, per_query: list[np.ndarray], threshold: float, k_max: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """score() on pre-extracted per-query row-index arrays."""
        n_kmers = np.array([r.shape[0] for r in per_query], np.int32)
        seg_rows: list[np.ndarray] = []
        owner: list[int] = []
        for qi, r in enumerate(per_query):
            if r.shape[0] == 0:
                continue
            for off in range(0, r.shape[0], k_max):
                seg_rows.append(r[off : off + k_max])
                owner.append(qi)
        d = len(self.doc_names)
        scores = np.zeros((len(per_query), d), np.int32)
        if seg_rows:
            n_real = len(seg_rows)
            if self.mesh is not None:
                # segment count must divide the query mesh axis; pad with
                # empty (all-padding-row) segments
                nq = self.mesh.shape["q"]
                for _ in range((-n_real) % nq):
                    seg_rows.append(np.empty((0, self.num_hashes), np.int64))
            # bucket the packed k-mer axis to multiples of 64 to bound the
            # number of distinct jit shapes
            k_pack = min(k_max, round_up(max(r.shape[0] for r in seg_rows), 64))
            packed, _ = pack_row_indices(
                seg_rows, k_pack, self.pad_row, self.num_hashes
            )
            if self.mesh is not None:
                from phylign_tpu.parallel.dist import dist_match_scores

                dev_scores = dist_match_scores(
                    self.mesh, self.words, jnp.asarray(packed)
                )
            else:
                dev_scores = self._device_scores(packed)
            max_score = k_pack  # per-segment count <= valid k-mer slots
            dtype = (
                jnp.uint8
                if max_score <= 255
                else jnp.uint16 if max_score <= 65535 else jnp.int32
            )
            d_pad = min(dev_scores.shape[1], round_up(d, 256))
            dev_scores = _compact_scores(dev_scores, d_pad, dtype)
            seg_scores = np.asarray(dev_scores)[:n_real, :d].astype(np.int32)
            np.add.at(scores, np.asarray(owner), seg_scores)
        keep = (scores >= threshold * np.maximum(n_kmers, 1)[:, None]) & (
            n_kmers[:, None] > 0
        )
        return scores, keep, n_kmers

    def _mesh_topk(
        self,
        per_query: list[np.ndarray],
        n_kmers: np.ndarray,
        threshold: float,
        kk: int,
        d: int,
        k_pack: int,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Mesh fast path: sharded scoring + threshold + distributed top-k
        (local top-k per doc shard -> all-gather over 'd' -> re-top-k) as
        ONE jitted global program, so only the [Q, kk] hit window leaves the
        device even when the score matrix is sharded across chips — and the
        whole thing runs on meshes spanning processes (jax.distributed)."""
        from jax.sharding import PartitionSpec as P

        from phylign_tpu.parallel.dist import dist_threshold_topk, fetch, global_array
        from phylign_tpu.parallel.mesh import AXIS_QUERY

        nq = self.mesh.shape["q"]
        rows = list(per_query)
        pad_q = (-len(rows)) % nq
        rows += [np.empty((0, self.num_hashes), np.int64)] * pad_q
        packed, _ = pack_row_indices(
            rows, max(k_pack, 1), self.pad_row, self.num_hashes
        )
        cut = np.concatenate(
            [_int_cut(threshold, n_kmers), np.full(pad_q, 1 << 30, np.int32)]
        )
        n_words = self.words.shape[1]
        kk_eff = min(kk, 32 * n_words)
        vals, ids, n_keep = fetch(
            dist_threshold_topk(
                self.mesh,
                self.words,
                global_array(self.mesh, packed, P(AXIS_QUERY, None, None)),
                global_array(self.mesh, cut, P(AXIS_QUERY)),
                d,
                kk_eff,
            )
        )
        q = len(n_kmers)
        return vals[:q, :kk], ids[:q, :kk], n_keep[:q]

    def score_hits(
        self, seqs: list[bytes], threshold: float, topn: int, k_max: int = 512
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Per-query hits [(doc_idx, score)] with score >= threshold*n_kmers,
        sorted by score desc, plus n_keep [Q] (the full qualifying count).

        Fast path: device-side threshold + top-k, transferring only a
        kk-entry window per query instead of the whole [Q, D] matrix (~5x
        fewer fetched bytes). The window is a SUPERSET of top-``topn`` + ties
        whenever it is complete; a query falls back to the full-matrix path
        when its qualifying set might overflow the window (n_keep > kk with
        the rank-topn tie run touching the window end).

        Queries with IDENTICAL k-mer row sets (exact duplicate reads and
        reverse-complement duplicates — canonical k-mers coincide) are scored
        ONCE and the result broadcast: real read sets carry 10-30% PCR
        duplicates, and every skipped query is a skipped [K, Wp] gather.
        Exact — every downstream value is identical.

        Mesh runs use the distributed top-k collective (local top-k per doc
        shard -> all-gather -> re-top-k); segmented (>k_max-k-mer) queries
        use the full path.
        """
        all_rows = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return self._score_hits_rows(all_rows, threshold, topn, k_max)

    def score_hits_raw(
        self,
        raw_hashes: list[np.ndarray],
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """score_hits on precomputed RAW k-mer hashes (kmer.cobs_kmer_hashes):
        a Bloom row is hash % signature_size, so callers scoring the same
        reads against MANY batch indexes hash once and re-mod per batch."""
        from phylign_tpu.kmer import rows_from_hashes

        all_rows = [rows_from_hashes(r, self.signature_size) for r in raw_hashes]
        return self._score_hits_rows(all_rows, threshold, topn, k_max)

    def _score_hits_rows(
        self,
        all_rows: list[np.ndarray],
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        rep_of, per_query = _dedup_row_sets(all_rows)
        if len(per_query) < len(all_rows):
            hits_u, n_keep_u = self.score_hits_unique(
                per_query, threshold, topn, k_max
            )
            hits = [hits_u[j] for j in rep_of]
            return hits, np.asarray([n_keep_u[j] for j in rep_of], np.int32)
        return self.score_hits_unique(per_query, threshold, topn, k_max)

    def score_hits_unique(
        self,
        per_query: list[np.ndarray],
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """score_hits on pre-extracted per-query row-index arrays."""
        d = len(self.doc_names)
        n_kmers = np.array([r.shape[0] for r in per_query], np.int32)
        segmented = any(r.shape[0] > k_max for r in per_query)
        if d == 0 or d > 65535 or segmented:
            scores, keep, _ = self.score_rows(per_query, threshold, k_max)
            return _hits_from_full(scores, keep), keep.sum(axis=1).astype(np.int32)

        kk = min(d, round_up(min(topn + 33, d), 32))
        k_pack = round_up(max((r.shape[0] for r in per_query), default=1), 64)
        if self.mesh is not None:
            vals, idx, n_keep = self._mesh_topk(
                per_query, n_kmers, threshold, kk, d, k_pack
            )
        else:
            packed, _ = pack_row_indices(
                per_query, max(k_pack, 1), self.pad_row, self.num_hashes
            )
            dev_scores = self._device_scores(packed)
            vals, idx, n_keep = jax.device_get(
                _topk_scores(
                    dev_scores, jnp.asarray(_int_cut(threshold, n_kmers)), kk, d
                )
            )
        return self._window_hits(
            vals, idx, n_keep, lambda q: per_query[q], threshold, k_max, kk
        )

    def _window_hits(
        self, vals, idx, n_keep, rows_of, threshold: float, k_max: int,
        kk: int, device_lock=None,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Assemble per-query hit lists from a fetched top-k window; queries
        whose qualifying set may overflow the window (n_keep > kk) re-score
        via the full-matrix path using ``rows_of(q)`` host row indices."""
        n_keep = np.array(n_keep)  # device_get buffers are read-only
        hits: list[list[tuple[int, int]]] = []
        redo: list[int] = []
        for q in range(len(n_keep)):
            m = int(n_keep[q])
            take = min(m, kk)
            if m > kk:
                # complete only if the rank-topn tie run ends inside the
                # window; conservative: re-fetch this query's full row
                redo.append(q)
                hits.append([])
                continue
            hits.append(
                [(int(idx[q, j]), int(vals[q, j])) for j in range(take)]
            )
        self._redo_overflow(
            hits, n_keep, redo, rows_of, threshold, k_max, device_lock
        )
        return hits, n_keep.astype(np.int32)

    def _redo_overflow(
        self, hits, n_keep, redo, rows_of, threshold: float, k_max: int,
        device_lock=None,
    ) -> None:
        """Re-score window-overflow queries via the full-matrix path.

        ``device_lock``: callers that fetch outside the pipeline's device
        lock (score_hits_hashes_end) pass it back in so this rare dense
        re-dispatch is serialized against concurrent align flushes rather
        than racing them for transient HBM."""
        if not redo:
            return
        import contextlib

        lock = device_lock if device_lock is not None else contextlib.nullcontext()
        with lock:
            scores, keep, _ = self.score_rows(
                [rows_of(q) for q in redo], threshold, k_max
            )
        for row, q in enumerate(redo):
            docs = np.nonzero(keep[row])[0]
            hits[q] = [(int(dd), int(scores[row, dd])) for dd in docs]
            hits[q].sort(key=lambda t: (-t[1], t[0]))
            n_keep[q] = len(hits[q])  # keep header count == emitted set

    def _window_hits_flat(
        self, flat, n_keep, rows_of, threshold: float, k_max: int, kk: int,
        device_lock=None,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """_window_hits over the device-compacted flat (score|doc) buffer
        (_hash_topk_flat): same hit lists, ~kk/take fewer fetched bytes."""
        n_keep = np.array(n_keep)
        take = np.minimum(n_keep, kk)
        offs = np.cumsum(take) - take
        ids = (flat & np.uint32(0xFFFF)).tolist()
        vals = (flat >> np.uint32(16)).tolist()
        # per-batch most queries have NO hits (a read's hits concentrate in
        # its own batch): share one empty list and touch only hit rows.
        # No consumer mutates a hit list in place (_broadcast_matches and
        # the postprocess top-n both build fresh lists).
        empty: list[tuple[int, int]] = []
        hits: list[list[tuple[int, int]]] = [empty] * len(n_keep)
        redo: list[int] = []
        offs_l, take_l = offs.tolist(), take.tolist()
        for q in np.flatnonzero(n_keep).tolist():
            if n_keep[q] > kk:
                redo.append(q)
                continue
            o, t = offs_l[q], take_l[q]
            hits[q] = list(zip(ids[o : o + t], vals[o : o + t]))
        self._redo_overflow(
            hits, n_keep, redo, rows_of, threshold, k_max, device_lock
        )
        return hits, n_keep.astype(np.int32)

    def score_hits_hashes_begin(
        self, dq, threshold: float, topn: int, k_max: int = 512,
        cap: int | None = None,
    ):
        """Async half of score_hits_hashes: DISPATCH the device program and
        return an opaque ctx (or None when this path does not apply —
        caller falls back to the synchronous score_hits_hashes). Lets the
        pipeline dispatch under the device lock and fetch/assemble outside
        it, so the next batch's program queues while this one's results
        cross the link.

        ``cap`` bounds the compacted hit buffer that crosses the link. The
        default (every query could fill its topn+ties window) is safe but
        pads the fetch ~tens-of-x on real workloads where most reads hit
        few documents per batch; callers with history (the pipelined match
        stage) pass a smaller cap — scatter overflow past it falls back to
        the dense window fetch, so a too-small cap costs time, never
        correctness."""
        d = len(self.doc_names)
        if (
            self.mesh is not None
            or self.dedup
            or d == 0
            or d > 65535
            or dq.hi.shape[1] > k_max
            or dq.hi.shape[2] != self.num_hashes
            or self.signature_size >= 1 << 31
        ):
            return None
        kk = min(d, round_up(min(topn + 33, d), 32))
        nk_d, cut_d = dq.nk_dev(), dq.cut_dev(threshold)
        q_real = dq.q_real if dq.q_real >= 0 else len(dq.n_kmers)
        full = q_real * min(kk, topn + 12)
        cap = full if cap is None else max(256, min(int(cap), full))
        out_dev = _hash_topk_flat(
            self.words, dq.hi, dq.lo, nk_d, cut_d, s=self.signature_size,
            pad_row=self.pad_row, kk=kk, d=d, cap=cap,
        )
        try:
            out_dev.copy_to_host_async()
        except AttributeError:  # pragma: no cover - backend-dependent
            pass
        return (dq, out_dev, threshold, topn, k_max, kk, cap)

    def score_hits_hashes_end(
        self, ctx, device_lock=None, fetched=None
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Fetch + assemble a score_hits_hashes_begin dispatch.

        Runs OUTSIDE the pipeline's device lock by design (overlaps the
        fetch with the next dispatch); the rare overflow fallbacks below
        dispatch heavy device programs, so they re-acquire ``device_lock``
        when the caller provides it. ``fetched``: the output array already
        device_get-fetched by a coalescing caller (one round trip for many
        batches) — skips the per-call fetch."""
        import contextlib

        from phylign_tpu.kmer import rows_from_hashes

        dq, out_dev, threshold, topn, k_max, kk, cap = ctx
        d = len(self.doc_names)
        rows_of = lambda q: rows_from_hashes(  # noqa: E731
            dq.raw[q], self.signature_size
        )
        q_real = dq.q_real if dq.q_real >= 0 else len(dq.n_kmers)
        out = jax.device_get(out_dev) if fetched is None else fetched
        flat = out[:cap]
        n_keep = out[cap : cap + len(dq.n_kmers)].astype(np.int32)
        total = out[-1]
        if int(total) <= cap:
            hits, nk = self._window_hits_flat(
                flat, n_keep, rows_of, threshold, k_max, kk,
                device_lock=device_lock,
            )
            return hits[:q_real], nk[:q_real]
        lock = device_lock if device_lock is not None else contextlib.nullcontext()
        with lock:
            nk_d, cut_d = dq.nk_dev(), dq.cut_dev(threshold)
            pend = _hash_topk(
                self.words, dq.hi, dq.lo, nk_d, cut_d,
                s=self.signature_size, pad_row=self.pad_row, kk=kk, d=d,
            )
        vals, idx, n_keep = jax.device_get(pend)
        hits, nk = self._window_hits(
            vals, idx, n_keep, rows_of, threshold, k_max, kk,
            device_lock=device_lock,
        )
        return hits[:q_real], nk[:q_real]

    def score_hits_hashes(
        self,
        dq: DeviceQueryHashes,
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """score_hits over DEVICE-RESIDENT raw hashes: the per-batch row
        computation (% signature_size) runs on device, so scoring a read set
        against many batches uploads the queries once, not once per batch.
        Bit-identical to score_hits_raw (tested); falls back to it for the
        mesh / segmented / huge-doc-count cases."""
        d = len(self.doc_names)
        if (
            self.mesh is not None
            or self.dedup
            or d == 0
            or d > 65535
            or dq.hi.shape[1] > k_max
            or dq.hi.shape[2] != self.num_hashes
            or self.signature_size >= 1 << 31  # u32 mod invariant
        ):
            return self.score_hits_raw(dq.raw, threshold, topn, k_max)
        from phylign_tpu.kmer import rows_from_hashes

        kk = min(d, round_up(min(topn + 33, d), 32))
        nk_d, cut_d = dq.nk_dev(), dq.cut_dev(threshold)
        rows_of = lambda q: rows_from_hashes(  # noqa: E731
            dq.raw[q], self.signature_size
        )
        # flat-compacted fetch: cap sized for the common few-hit regime;
        # scatter overflow (total > cap, e.g. every query carrying a full
        # tie window) falls back to the dense window fetch
        q_real = dq.q_real if dq.q_real >= 0 else len(dq.n_kmers)
        cap = q_real * min(kk, topn + 12)
        out = jax.device_get(
            _hash_topk_flat(
                self.words, dq.hi, dq.lo, nk_d, cut_d,
                s=self.signature_size,
                pad_row=self.pad_row, kk=kk, d=d, cap=cap,
            )
        )
        flat = out[:cap]
        n_keep = out[cap : cap + len(dq.n_kmers)].astype(np.int32)
        total = out[-1]
        if int(total) <= cap:
            hits, nk = self._window_hits_flat(
                flat, n_keep, rows_of, threshold, k_max, kk
            )
            return hits[:q_real], nk[:q_real]
        vals, idx, n_keep = jax.device_get(
            _hash_topk(
                self.words,
                dq.hi,
                dq.lo,
                nk_d,
                cut_d,
                s=self.signature_size,
                pad_row=self.pad_row,
                kk=kk,
                d=d,
            )
        )
        hits, nk = self._window_hits(
            vals,
            idx,
            n_keep,
            rows_of,
            threshold,
            k_max,
            kk,
        )
        return hits[:q_real], nk[:q_real]


@functools.partial(jax.jit, donate_argnums=(0,))
def _acc_chunk_scores(acc: jax.Array, words: jax.Array, row_idx: jax.Array):
    """acc += this row-block's partial scores (donated: in-place on device)."""
    return acc + match_scores_xla(words, row_idx)


@dataclass
class ChunkedMatcher:
    """Row-chunked match model: scores an index LARGER than the HBM budget.

    The largest real batch decompresses to 10.59 GB
    (ref: /root/reference/data/decompressed_indexes_sizes.txt,
    pseudomonas_aeruginosa__01). That fits resident on a large card, but a
    device whose budget (``device_hbm_gb``) is smaller cannot hold it next
    to the align stage's buffers: a resident upload would OOM.

    Instead the signature rows stream through the device in fixed blocks:
    each query k-mer row index is remapped into the current block (or to the
    block's zero padding row when it falls outside), the block is scored
    with the SAME gather/popcount kernel, and per-(query, doc) scores
    accumulate on device across blocks. Bit-exact vs Matcher for
    num_hashes == 1 (the 661k DB's value, docs/cobs_format.md) because a
    1-hash score is a plain sum over k-mer rows; multi-hash indexes need
    the AND of rows that may straddle blocks and must use Matcher.

    The upload streams the whole index once per query super-pass, so
    ``queries_per_pass`` is sized to score every read of a run in as few
    passes as the [Q, D] score accumulator allows (default 256 MB).
    """

    term_size: int
    num_hashes: int
    signature_size: int
    doc_names: list[str]
    words_host: np.ndarray  # uint32 [S, W] on HOST (array or memmap)
    row_chunk: int  # signature rows per device block
    acc_budget_bytes: int = 256 << 20

    def __post_init__(self):
        if self.num_hashes != 1:
            raise ValueError(
                "ChunkedMatcher requires num_hashes == 1 (a multi-hash "
                "k-mer ANDs rows that may straddle row blocks); "
                f"got {self.num_hashes}. Use Matcher."
            )

    @classmethod
    def from_device_index(
        cls, didx: DeviceIndex, hbm_budget_mb: int, **kw
    ) -> "ChunkedMatcher":
        """Size row blocks so block + accumulator + double-buffer margin fit
        the given budget."""
        w = max(1, didx.num_words)
        acc = kw.get("acc_budget_bytes", 256 << 20)
        usable = max(64 << 20, hbm_budget_mb * 1_000_000 - acc)
        rows = max(1024, int(usable // 2 // (w * 4)))  # 2 blocks in flight
        return cls(
            term_size=didx.term_size,
            num_hashes=didx.num_hashes,
            signature_size=didx.signature_size,
            doc_names=didx.doc_names,
            words_host=np.asarray(didx.words),
            row_chunk=min(rows, didx.signature_size),
            **kw,
        )

    @property
    def pad_row(self) -> int:
        """GLOBAL padding sentinel: outside every block's [r0, r1) range, so
        padding slots always remap to the block's zero row. (The block-local
        pad row is ``row_chunk``; a small global value like it would collide
        with real row numbers.)"""
        return 1 << 30

    def _score_pass(self, packed: np.ndarray) -> jax.Array:
        """Accumulated scores [Q, 32*W] for one query super-pass (device)."""
        s, w = self.words_host.shape
        q = packed.shape[0]
        acc = jnp.zeros((q, 32 * w), jnp.int32)
        idx2 = packed.reshape(q, -1)  # [Q, K*H] int32 global rows
        pending = None  # (dev_words, dev_idx) double buffer
        for r0 in range(0, s, self.row_chunk):
            r1 = min(r0 + self.row_chunk, s)
            block = np.zeros((self.row_chunk + 1, w), np.uint32)
            block[: r1 - r0] = self.words_host[r0:r1]
            # rows outside this block -> the block's zero padding row
            loc = idx2 - r0
            loc = np.where((idx2 >= r0) & (idx2 < r1), loc, self.row_chunk)
            up = jax.device_put((block, loc.astype(np.int32)))
            if pending is not None:
                acc = _acc_chunk_scores(acc, *pending)
            pending = up
        if pending is not None:
            acc = _acc_chunk_scores(acc, *pending)
        return acc

    def score_rows(
        self, per_query: list[np.ndarray], threshold: float, k_max: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Matcher.score_rows semantics (full [Q, D] scores on host)."""
        d = len(self.doc_names)
        n_kmers = np.array([r.shape[0] for r in per_query], np.int32)
        kp = round_up(max((r.shape[0] for r in per_query), default=1), 64)
        packed, _ = pack_row_indices(
            per_query, max(kp, 1), self.pad_row, self.num_hashes
        )
        scores = np.asarray(self._score_pass(packed))[:, :d].astype(np.int32)
        keep = (scores >= threshold * np.maximum(n_kmers, 1)[:, None]) & (
            n_kmers[:, None] > 0
        )
        return scores, keep, n_kmers

    def score_hits(
        self, seqs: list[bytes], threshold: float, topn: int, k_max: int = 512
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Matcher.score_hits contract (same dedup, same top-k window +
        tie-overflow refetch), with the index streamed in row blocks."""
        all_rows = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return self._score_hits_rows(all_rows, threshold, topn)

    def score_hits_raw(
        self, raw_hashes: list[np.ndarray], threshold: float, topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Matcher.score_hits_raw twin: precomputed raw k-mer hashes."""
        from phylign_tpu.kmer import rows_from_hashes

        all_rows = [rows_from_hashes(r, self.signature_size) for r in raw_hashes]
        return self._score_hits_rows(all_rows, threshold, topn)

    def _score_hits_rows(
        self, all_rows: list[np.ndarray], threshold: float, topn: int
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        rep_of, per_query = _dedup_row_sets(all_rows)
        hits_u, n_keep_u = self._score_hits_unique(per_query, threshold, topn)
        if len(per_query) < len(all_rows):
            return (
                [hits_u[j] for j in rep_of],
                np.asarray([n_keep_u[j] for j in rep_of], np.int32),
            )
        return hits_u, n_keep_u

    def _score_hits_unique(
        self, per_query: list[np.ndarray], threshold: float, topn: int
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        d = len(self.doc_names)
        n_kmers_all = np.array([r.shape[0] for r in per_query], np.int32)
        w = max(1, self.words_host.shape[1])
        q_pass = max(64, int(self.acc_budget_bytes // (32 * w * 4)))
        hits: list[list[tuple[int, int]]] = []
        n_keep_out: list[int] = []
        for off in range(0, len(per_query), q_pass):
            part = per_query[off : off + q_pass]
            n_kmers = n_kmers_all[off : off + q_pass]
            kp = round_up(max((r.shape[0] for r in part), default=1), 64)
            packed, _ = pack_row_indices(
                part, max(kp, 1), self.pad_row, self.num_hashes
            )
            acc = self._score_pass(packed)
            if d == 0 or d > 65535:
                scores = np.asarray(acc)[:, :d].astype(np.int32)
                keep = (
                    scores >= threshold * np.maximum(n_kmers, 1)[:, None]
                ) & (n_kmers[:, None] > 0)
                hits.extend(_hits_from_full(scores, keep))
                n_keep_out.extend(keep.sum(axis=1).astype(int).tolist())
                continue
            kk = min(d, round_up(min(topn + 33, d), 32))
            vals, idx, n_keep = jax.device_get(
                _topk_scores(
                    acc, jnp.asarray(_int_cut(threshold, n_kmers)), kk, d
                )
            )
            scores_full = None
            for qi in range(len(part)):
                m = int(n_keep[qi])
                if m > kk:  # tie overflow: read this query's full row
                    if scores_full is None:
                        scores_full = np.asarray(acc)[:, :d]
                    row = scores_full[qi]
                    cut = int(_int_cut(threshold, n_kmers[qi : qi + 1])[0])
                    docs = np.nonzero(row >= cut)[0]
                    hl = [(int(dd), int(row[dd])) for dd in docs]
                    hl.sort(key=lambda t: (-t[1], t[0]))
                    hits.append(hl)
                    n_keep_out.append(len(hl))
                    continue
                hits.append(
                    [(int(idx[qi, j]), int(vals[qi, j])) for j in range(m)]
                )
                n_keep_out.append(m)
        return hits, np.asarray(n_keep_out, np.int32)


def _dedup_row_sets(
    rows: list[np.ndarray],
) -> tuple[list[int], list[np.ndarray]]:
    """Group queries by identical k-mer row-index arrays.

    Returns (rep_of, unique): rep_of[q] is the index into ``unique`` whose
    row MULTISET equals rows[q]'s. Scores are a sum over k-mer slots, so any
    order-permutation of the same rows yields identical scores for every
    document — which collapses exact duplicate reads AND reverse-complement
    duplicates (canonical k-mers are strand-invariant; RC merely reverses
    their position order)."""
    seen: dict[tuple[int, bytes], int] = {}
    rep_of: list[int] = []
    unique: list[np.ndarray] = []
    for r in rows:
        if r.ndim == 1 or r.shape[-1] == 1:
            # 1 hash (the 661k DB): plain value sort, no lexsort machinery
            canon = np.sort(r.reshape(-1), kind="stable")
        else:  # [n, H]: lexicographic row sort
            canon = r[np.lexsort(r.T[::-1])] if r.shape[0] else r
        key = (r.shape[0], canon.tobytes())
        j = seen.get(key)
        if j is None:
            j = len(unique)
            seen[key] = j
            unique.append(r)
        rep_of.append(j)
    return rep_of, unique


def _hits_from_full(
    scores: np.ndarray, keep: np.ndarray
) -> list[list[tuple[int, int]]]:
    out = []
    for q in range(scores.shape[0]):
        docs = np.nonzero(keep[q])[0]
        row = [(int(d), int(scores[q, d])) for d in docs]
        row.sort(key=lambda t: (-t[1], t[0]))
        out.append(row)
    return out
