"""Batched anchor chaining DP (minimap2-style) on device.

Replaces minimap2's mm_chain_dp for every preset (the reference invokes
minimap2 once per (batch, candidate genome):
/root/reference/scripts/batch_align.py:264-313). All (query, genome) pairs of
a batch are chained together as one [P, A] tensor program: P pairs, A padded
anchor slots.

Scoring (minimap2's mm_chain_dp model, including its score SCALE — the
chain score feeds mm_set_mapq and the s1/s2 SAM tags, so absolute values
matter):
    f[i] = max(seed_weight, max_{j in window} f[j] + gain(j, i) - gap(j, i))
    gain = min(dq, dr, k);   gap = 0.01 * k * dd + 0.5 * log2(dd + 1)
    with dd = |dr - dq|; transition allowed iff 0 < dr <= max_gap,
    0 < dq <= max_gap, dd <= bandwidth. Anchors are sorted by (rpos, qpos).
    An edge contributes only its newly-matched bases (min(dq, dr, k)); the
    seed weight k enters once at the chain root, exactly like mm2's
    f[i] = max(q_span, f[j] + comput_sc) — a 150 bp short read chains to
    ~140, mm2's scale, not ~3.5x it.

Structure (fixed shapes, bounded memory):
  * the DP is a ``lax.scan`` over anchor slots carrying a rolling
    ``LOOKBACK``-wide window of the previous anchors' (f, rpos, qpos) —
    O(A * W) compute and O(A) memory, so A scales to thousands of anchors
    (long-read/asm presets) where the round-1 dense [P, A, A] transition
    tensor could not. The bounded predecessor window mirrors minimap2's own
    bounded chaining iteration (its DP checks a capped number of
    predecessors per anchor); for A <= LOOKBACK the window spans every
    predecessor and the DP is exact.
  * backtracking uses pointer doubling (log2 A rounds of parent-jumping)
    instead of A sequential hops, giving every slot its chain start + length.
  * chain selection returns the primary plus up to ``n_sup`` further chains,
    each mostly-disjoint (query-overlap < 0.5 of the shorter span,
    minimap2's mask_level) from ALL previously selected chains — the
    split-read segments — plus the best overlapping competitor score
    (minimap2's s2, feeding mapq).

Padding: invalid slots carry rpos = qpos = PAD_POS; every transition to or
from them violates the distance bounds, and their standalone score is
ignored by masking at the argmax.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

PAD_POS = np.int32(2**30)

# predecessor-window width of the scan DP (minimap2's chaining likewise
# bounds how far back it looks per anchor); exact for anchor sets <= this
LOOKBACK = 64

# hard ceiling on padded anchor slots per (pair, strand); anchor sets larger
# than this are truncated WITH a log (align.engine counts overflow) — a 10 kb
# read at sr-minimizer density yields ~2k anchors, well inside
MAX_ANCHORS = 4096


class ChainResult(NamedTuple):
    # primary chain per pair: best-scoring DP cell
    score: jax.Array  # f32 [P]
    count: jax.Array  # int32 [P] anchors on the chain
    qs: jax.Array  # int32 [P] query start (first anchor kmer start)
    qe: jax.Array  # int32 [P] query end (last anchor kmer start + k)
    rs: jax.Array  # int32 [P] ref start
    re: jax.Array  # int32 [P] ref end
    # best chain overlapping the primary's query interval by >= mask_level
    # (the s2 competitor for mapq); < 0 when none exists. Coordinates of
    # that competitor ride along so the align engine can DP-extend it: mm2's
    # MAPQ needs the secondary region's DP score (dp_max2, hit.c
    # mm_set_parent/mm_set_mapq), not just its chain score.
    alt_score: jax.Array  # f32 [P]
    alt_qs: jax.Array  # int32 [P] (garbage when alt_score < 0)
    alt_qe: jax.Array  # int32 [P]
    alt_rs: jax.Array  # int32 [P]
    alt_re: jax.Array  # int32 [P]
    # up to n_sup further chains, each mostly-disjoint from every previously
    # selected chain (split-read segments); score < 0 marks an empty slot
    sup_score: jax.Array  # f32 [P, n_sup]
    sup_count: jax.Array  # int32 [P, n_sup]
    sup_qs: jax.Array  # int32 [P, n_sup]
    sup_qe: jax.Array  # int32 [P, n_sup]
    sup_rs: jax.Array  # int32 [P, n_sup]
    sup_re: jax.Array  # int32 [P, n_sup]


@functools.partial(
    jax.jit, static_argnames=("k", "max_gap", "bandwidth", "n_sup", "lookback")
)
def chain_anchors_packed(
    rpos: jax.Array,  # int32 [P, A]
    qpos_u16: jax.Array,  # uint16 [P, A] — transfer-compact query positions
    k: int = 21,
    max_gap: int = 100,
    bandwidth: int = 100,
    n_sup: int = 2,
    lookback: int = LOOKBACK,
) -> "ChainResult":
    """chain_anchors with qpos shipped as uint16 (halves the second H2D
    array; slot validity comes from rpos alone, so padded qpos values are
    free). Callers must ensure real qpos < 2**16 (true for any query the
    align engine buckets; it falls back to the int32 path otherwise)."""
    return chain_anchors(
        rpos, qpos_u16.astype(jnp.int32), k=k, max_gap=max_gap,
        bandwidth=bandwidth, n_sup=n_sup, lookback=lookback,
    )


@functools.partial(
    jax.jit, static_argnames=("k", "max_gap", "bandwidth", "n_sup", "lookback")
)
def chain_anchors(
    rpos: jax.Array,  # int32 [P, A], PAD_POS for padding; sorted (rpos, qpos)
    qpos: jax.Array,  # int32 [P, A]
    k: int = 21,
    max_gap: int = 100,
    bandwidth: int = 100,
    n_sup: int = 2,
    lookback: int = LOOKBACK,
) -> ChainResult:
    p, a = rpos.shape
    w = min(lookback, a)
    valid = rpos < PAD_POS
    neg = jnp.float32(-1e30)
    seed_w = jnp.float32(k)
    kf = jnp.float32(k)
    gapf = jnp.float32(max_gap)
    bandf = jnp.float32(bandwidth)

    rposf = rpos.astype(jnp.float32)
    # padded slots must kill transitions in FLOAT arithmetic too: map them
    # far away so dr > max_gap regardless of the window contents
    rposf = jnp.where(valid, rposf, jnp.float32(2.0e9))
    qposf = jnp.where(valid, qpos.astype(jnp.float32), jnp.float32(2.0e9))

    def step(carry, xs):
        fbuf, rbuf, qbuf = carry  # [P, W] rolling window, oldest first
        ri, qi, i = xs  # [P], [P], scalar slot index
        dr = ri[:, None] - rbuf  # [P, W]
        dq = qi[:, None] - qbuf
        dd = jnp.abs(dr - dq)
        ok = (dr > 0) & (dq > 0) & (dr <= gapf) & (dq <= gapf) & (dd <= bandf)
        gain = jnp.minimum(jnp.minimum(dq, dr), kf)
        cost = 0.01 * kf * dd + 0.5 * jnp.log2(dd + 1.0)
        cand = jnp.where(ok, fbuf + gain - cost, neg)
        # tie-break toward the NEAREST predecessor (mm2 iterates j from i-1
        # downward with a strict compare): argmax over the reversed window
        best_w = (
            jnp.int32(w - 1)
            - jnp.argmax(cand[:, ::-1], axis=1).astype(jnp.int32)
        )  # [P]
        best_v = jnp.take_along_axis(cand, best_w[:, None], axis=1)[:, 0]
        # parent only when strictly better than standalone (mm2's `sc >
        # max_f` with max_f initialized to the seed weight)
        use = best_v > seed_w
        fi = jnp.maximum(best_v, seed_w)
        par_i = jnp.where(use, i - w + best_w, jnp.int32(-1))
        fbuf = jnp.concatenate([fbuf[:, 1:], fi[:, None]], axis=1)
        rbuf = jnp.concatenate([rbuf[:, 1:], ri[:, None]], axis=1)
        qbuf = jnp.concatenate([qbuf[:, 1:], qi[:, None]], axis=1)
        return (fbuf, rbuf, qbuf), (fi, par_i)

    init = (
        jnp.full((p, w), neg, jnp.float32),
        jnp.full((p, w), 2.0e9, jnp.float32),
        jnp.full((p, w), 2.0e9, jnp.float32),
    )
    xs = (rposf.T, qposf.T, jnp.arange(a, dtype=jnp.int32))
    _, (f_t, par_t) = jax.lax.scan(step, init, xs)
    f = f_t.T  # [P, A]
    parent = par_t.T  # [P, A], -1 = chain start
    f = jnp.where(valid, f, neg)

    # pointer doubling: chain start + edge count for EVERY slot in log2(A)
    # parent-jumping rounds (vs A sequential hops)
    iota = jnp.broadcast_to(jnp.arange(a, dtype=jnp.int32)[None, :], (p, a))
    par = jnp.where(parent >= 0, parent, iota)  # roots self-loop
    cnt = (parent >= 0).astype(jnp.int32)
    rounds = max(1, int(np.ceil(np.log2(max(a, 2)))))
    for _ in range(rounds):
        cnt = cnt + jnp.take_along_axis(cnt, par, axis=1)
        par = jnp.take_along_axis(par, par, axis=1)
    start_all, cnt_all = par, cnt + 1

    qs_all = jnp.take_along_axis(qpos, start_all, axis=1)  # [P, A]
    qe_all = qpos + k  # the end anchor of slot i is i itself
    rs_all = jnp.take_along_axis(rpos, start_all, axis=1)

    take = lambda arr, idx: jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]
    end = jnp.argmax(f, axis=1).astype(jnp.int32)  # [P]
    score1 = take(f, end)
    qs1, qe1 = take(qs_all, end), take(qe_all, end)

    def overlap_frac_ok(sel_qs, sel_qe, sel_live):
        """[P, A] mask: slot interval overlaps (sel_qs, sel_qe) by >= half of
        the shorter span; False everywhere when the selection is not live."""
        ov = jnp.maximum(
            0,
            jnp.minimum(qe_all, sel_qe[:, None])
            - jnp.maximum(qs_all, sel_qs[:, None]),
        ).astype(jnp.float32)
        span = jnp.minimum(
            qe_all - qs_all, (sel_qe - sel_qs)[:, None]
        ).astype(jnp.float32)
        return (ov >= 0.5 * span) & sel_live[:, None]

    live1 = score1 > 0.0
    # s2: best chain overlapping the primary, EXCLUDING every cell that
    # shares the primary's chain root — the primary's own prefix cells (and
    # branches merging into it) are anchors mm2 marks as used, not
    # competitors. Its end-cell index yields the competitor's coordinates
    # for the MAPQ DP probe (mm2 extends every retained secondary region).
    # Branches that diverge FROM the primary's prefix are conservatively
    # excluded too (mm2 would enumerate their suffix at a differential
    # score); genuine second loci have distinct roots and score exactly.
    prim_root = take(start_all, end)
    on_prim = start_all == prim_root[:, None]
    alt_mask = overlap_frac_ok(qs1, qe1, live1) & valid & ~on_prim
    f_alt = jnp.where(alt_mask, f, neg)
    alt_end = jnp.argmax(f_alt, axis=1).astype(jnp.int32)
    alt_score = take(f_alt, alt_end)

    # split-read segments: iteratively take the best chain mostly-disjoint
    # from every chain selected so far (primary included)
    blocked = overlap_frac_ok(qs1, qe1, live1) | ~valid
    sup = {key: [] for key in ("score", "count", "qs", "qe", "rs", "re")}
    for _ in range(n_sup):
        fn = jnp.where(blocked, neg, f)
        end_n = jnp.argmax(fn, axis=1).astype(jnp.int32)
        score_n = take(fn, end_n)
        live_n = score_n > 0.0
        qs_n, qe_n = take(qs_all, end_n), take(qe_all, end_n)
        sup["score"].append(score_n)
        sup["count"].append(take(cnt_all, end_n))
        sup["qs"].append(qs_n)
        sup["qe"].append(qe_n)
        sup["rs"].append(take(rs_all, end_n))
        sup["re"].append(take(rpos, end_n) + k)
        blocked = blocked | overlap_frac_ok(qs_n, qe_n, live_n) | (
            (iota == end_n[:, None]) & live_n[:, None]
        )

    stack = lambda key: jnp.stack(sup[key], axis=1)  # [P, n_sup]
    return ChainResult(
        score=score1,
        count=take(cnt_all, end),
        qs=qs1,
        qe=qe1,
        rs=take(rs_all, end),
        re=take(rpos, end) + k,
        alt_score=alt_score,
        alt_qs=take(qs_all, alt_end),
        alt_qe=take(qe_all, alt_end),
        alt_rs=take(rs_all, alt_end),
        alt_re=take(rpos, alt_end) + k,
        sup_score=stack("score"),
        sup_count=stack("count"),
        sup_qs=stack("qs"),
        sup_qe=stack("qe"),
        sup_rs=stack("rs"),
        sup_re=stack("re"),
    )


def chain_oracle(
    rpos: np.ndarray,
    qpos: np.ndarray,
    k=21,
    max_gap=100,
    bandwidth=100,
    lookback: int | None = None,
):
    """Scalar numpy transliteration of the same DP, for tests.

    ``lookback=None`` runs the exact full-predecessor DP (equals the kernel
    whenever A <= LOOKBACK); an int bounds the predecessor window exactly
    like the kernel's rolling buffer."""
    a = len(rpos)
    f = np.full(a, float(k))
    parent = np.full(a, -1)
    for i in range(1, a):
        best, bj = float(k), -1  # standalone seed weight (mm2's max_f init)
        j0 = 0 if lookback is None else max(0, i - lookback)
        for j in range(i - 1, j0 - 1, -1):  # nearest first (mm2 loop order)
            dr, dq = rpos[i] - rpos[j], qpos[i] - qpos[j]
            dd = abs(dr - dq)
            if dr <= 0 or dq <= 0 or dr > max_gap or dq > max_gap or dd > bandwidth:
                continue
            sc = min(dq, dr, k) - (0.01 * k * dd + 0.5 * np.log2(dd + 1))
            if f[j] + sc > best:
                best, bj = f[j] + sc, j
        f[i] = best
        parent[i] = bj
    end = int(np.argmax(f))
    cnt, cur = 1, end
    while parent[cur] >= 0:
        cur = parent[cur]
        cnt += 1
    return f[end], cnt, qpos[cur], qpos[end] + k, rpos[cur], rpos[end] + k
