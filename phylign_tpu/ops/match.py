"""Device match engine: k-mer containment scoring over a packed Bloom bit-matrix.

This is the device replacement for ``cobs query``'s hot loop
(ref: /root/reference/Snakefile:419-427; SURVEY.md section 2b): for each query
k-mer, gather its Bloom row(s) from the packed bit-matrix and accumulate a
per-document hit count.

Data model
----------
  words     uint32 [S+1, Wp]   packed bit-matrix: doc d lives at word d//32,
                               bit d%32 (see phylign_tpu.io.cobs.DeviceIndex).
                               Row S (the last) is all-zero: the padding row.
                               Wp is the exact word width unless a mesh needs
                               it padded to a multiple of its doc axis.
  row_idx   int32  [Q, K]      per query, K k-mer slots; each slot is a Bloom
                               row index, or S (the zero row) for padding /
                               absent k-mers. For num_hashes > 1 the slot axis
                               is [Q, K, H] and a k-mer hits only if ALL H
                               rows have the doc bit (AND before counting).
  scores    int32  [Q, 32*Wp]  per (query, doc) hit counts; callers slice
                               [:, :num_docs].

``match_scores_xla`` is plain jnp (gather + bit-unpack + K-sum) and is the one
implementation on every backend; ``match/oracle.py`` is its numpy reference.

The padding-row trick keeps every shape static: invalid slots contribute 0
to every document, so no masks enter the inner loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_device_words(words: np.ndarray, lane_words: int = 1) -> np.ndarray:
    """[S, W] uint32 -> [S+1, Wp] with Wp a multiple of ``lane_words`` and a
    final all-zero padding row.

    lane_words=1 (exact width) is the single-device layout: padding words
    would only add gathered and uploaded bytes. Mesh sharding passes a
    multiple of the doc-axis size so every shard holds equal columns."""
    s, w = words.shape
    wp = round_up(max(w, 1), lane_words)
    out = np.zeros((s + 1, wp), dtype=np.uint32)
    out[:s, :w] = words
    return out


def pack_row_indices(
    rows_per_query: list[np.ndarray], k_max: int, pad_row: int, num_hashes: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-query [n_kmers, H] row-index arrays into [Q, K, H] int32 plus
    the per-query valid k-mer counts [Q] int32. Queries with more than k_max
    k-mers are rejected (caller buckets by length)."""
    q = len(rows_per_query)
    out = np.full((q, k_max, num_hashes), pad_row, dtype=np.int32)
    counts = np.zeros(q, dtype=np.int32)
    for i, r in enumerate(rows_per_query):
        n = r.shape[0]
        if n > k_max:
            raise ValueError(f"query {i} has {n} k-mers > k_max={k_max}")
        out[i, :n] = r
        counts[i] = n
    return out, counts


# --- XLA reference implementation -------------------------------------------


@jax.jit
def match_scores_xla(words: jax.Array, row_idx: jax.Array) -> jax.Array:
    """Gather + vertical popcount in pure jnp.

    words: uint32 [S+1, Wp]; row_idx: int32 [Q, K] or [Q, K, H].
    Returns int32 [Q, 32*Wp] (doc d at index (d//32)*32 + d%32 == d).

    Written as unchunked expressions on purpose: XLA fuses the shift/mask
    unpack and the K-reduction into the gather consumer, so the [Q,K,Wp,32]
    intermediate never materializes. The gather is split into 4 interleaved
    K-slices (independent gather streams). On an H100 (80GB HBM3, 700 W) at
    S=2M, Wp=68, Q=2048, K=128 a call takes 0.90 ms of device time (2.3M
    queries/s): 3% of the HBM bound for the 89 MB it moves, the time going
    to the unpack-and-sum fusion rather than to memory (PERF.md). Callers
    bound Q via config.device_query_chunk.
    """
    if row_idx.ndim == 2:
        row_idx = row_idx[..., None]
    q, k, h = row_idx.shape
    wp = words.shape[1]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    n_split = 4 if k >= 8 else 1
    acc = jnp.zeros((q, wp, 32), jnp.int32)
    for i in range(n_split):
        g = words[row_idx[:, i::n_split]]  # [Q, K/n, H, Wp] uint32
        if h > 1:
            a = g[:, :, 0, :]
            for j in range(1, h):
                a = a & g[:, :, j, :]
            g = a
        else:
            g = g[:, :, 0, :]
        bits = (g[..., None] >> shifts) & jnp.uint32(1)  # [Q, K/n, Wp, 32]
        acc = acc + bits.astype(jnp.int32).sum(axis=1)  # [Q, Wp, 32]
    # doc d lives at (w=d//32)*32 + (b=d%32)
    return acc.reshape(q, wp * 32)


# --- cross-query k-mer dedup (two-stage gather) ------------------------------

#: largest unique-row table the dedup path builds: a small gather source
#: stays cache-resident, which is what makes the second gather cheap
DEDUP_FAST_BYTES = 40 << 20

#: dedup pays only when stage-1 (U big-gathers) + stage-2 (N small-table
#: gathers) undercuts N big-gathers, i.e. when U/N is small enough. Both
#: gate values predate the H100 and are re-measured with bench.py --dedup.
DEDUP_MAX_FRAC = 0.55


def dedup_rows(
    row_idx: np.ndarray, pad_row: int, wp: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Host half of the two-stage dedup gather: unique row indices (padded
    to a power-of-two bucket with ``pad_row``) + inverse indices, or None
    when the dedup would not be profitable (low cross-query duplication, or
    a unique table too large for the fast-gather regime).

    Real read sets share k-mers across overlapping reads; gathering each
    distinct Bloom row ONCE into a small device table and re-gathering from
    it can beat the big-table gather when enough of the chunk's row indices
    are duplicates (the DEDUP_* gate above).
    """
    flat = row_idx.reshape(-1)
    from phylign_tpu import native

    nat = native.native_unique_inverse(flat)
    if nat is not None:
        uniq, inv = nat
    else:
        uniq, inv = np.unique(flat, return_inverse=True)
        inv = inv.astype(np.int32)
    u, n = uniq.size, flat.size
    up = 1 << max(10, int(np.ceil(np.log2(u + 1))))
    if up * wp * 4 > DEDUP_FAST_BYTES or u > DEDUP_MAX_FRAC * n:
        return None
    uniq_pad = np.full(up, pad_row, np.int32)
    uniq_pad[:u] = uniq
    return uniq_pad, inv.reshape(row_idx.shape)


@jax.jit
def match_scores_xla_dedup(
    words: jax.Array, uniq_pad: jax.Array, inv: jax.Array
) -> jax.Array:
    """Two-stage scoring: gather the chunk's unique Bloom rows into a small
    table, then run the standard kernel against it.
    Bit-identical to match_scores_xla(words, row_idx) for the (uniq, inv)
    pair produced by dedup_rows: padding slots index ``pad_row`` whose row
    is all-zero in both tables."""
    return match_scores_xla(words[uniq_pad], inv)
