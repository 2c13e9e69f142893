"""Banded dual-affine-gap alignment extension (batched, device DP + host CIGAR).

Replaces minimap2's DP extension for the sr preset
(ref: /root/reference/scripts/batch_align.py:268-270 runs
``minimap2 -a -x sr --eqx``; sr scoring: match 2, mismatch 8, gaps
min(12 + 2*len, 32 + 1*len)). Produces --eqx style CIGARs ('='/'X' instead
of 'M'), the golden-output convention
(ref: /root/reference/data/reads_1___*.sam_summary.xz, e.g. '55=1X94=').

Geometry: each (query, genome) pair aligns the full (strand-adjusted) query
against a ref window centered on the chain diagonal. Band coordinates:
query row i maps to window column i + d for band offset d in [0, BAND).
The alignment is "glocal": the query aligns end-to-end, the ref window has
free leading/trailing overhang (row -1 is all zeros; the result is the max
over d of the last query row).

The within-row deletion recurrence is solved with the prefix-max trick so
each DP row is fully vectorized:
    D[d] = max_{d'<d} (P[d'] + d'*E) - O - E - d*E   via lax.cummax
where P = max(diag-move H, I). The device emits the final row scores plus
the per-cell P plane; the host reconstructs H/I/D rows on demand and walks
the traceback (gaps are rare, so per-gap argmax recomputation is cheap).

Layout: the band is 128 cells wide for the sr preset (512 for long-read
presets); the width is part of the result, since it bounds how far an
alignment may drift off the seed diagonal. Rows scan via lax.scan;
everything is [P, BAND] f32 with one pair per row.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

BAND = 128  # default band width (sr preset); _extend_impl infers the
# actual band from its window shape, so wider presets just pass wider rwin
NEG = np.float32(-1e30)


@dataclass(frozen=True)
class SrScoring:
    """minimap2 sr preset scoring (-A2 -B8 -O12,32 -E2,1)."""

    match: int = 2
    mismatch: int = 8
    gap_open1: int = 12
    gap_ext1: int = 2
    gap_open2: int = 32
    gap_ext2: int = 1
    min_dp_score: int = 40  # -s: min score to emit an alignment


class ExtendResult(NamedTuple):
    score: jax.Array  # f32 [P] best glocal score at the final query row
    end_d: jax.Array  # int32 [P] band offset of the best final cell
    p_plane: jax.Array  # f32 [P, L, BAND] the P = max(diag, I) plane


@functools.partial(jax.jit, static_argnames=("scoring",))
def extend_banded_scores(
    q_codes: jax.Array,
    q_len: jax.Array,
    rwin: jax.Array,
    rwin_valid: jax.Array,
    scoring: SrScoring = SrScoring(),
) -> tuple[jax.Array, jax.Array]:
    """Score-only banded extension: (score [P], end_d [P]).

    Skips the traceback plane entirely — no [P, L, BAND] buffer and no bulk
    device->host transfer. The align engine resolves gapless alignments
    (the common case for short reads) directly on the end diagonal and only
    re-runs the plane variant for pairs whose score implies indels.
    """
    res = _extend_impl(q_codes, q_len, rwin, rwin_valid, scoring, False)
    return res.score, res.end_d


def pack2bit(a: np.ndarray) -> np.ndarray:
    """[P, N] uint8 codes (0..3) -> [P, ceil(N/4)] uint8, 4 codes per byte
    (code j in bits 2*(j%4)). Shrinks the extension's H2D bytes 4x."""
    p, n = a.shape
    npad = (-n) % 4
    if npad:
        a = np.concatenate([a, np.zeros((p, npad), np.uint8)], axis=1)
    a4 = a.reshape(p, -1, 4)
    return (
        a4[:, :, 0]
        | (a4[:, :, 1] << 2)
        | (a4[:, :, 2] << 4)
        | (a4[:, :, 3] << 6)
    )


def _unpack2bit(packed: jax.Array, n: int) -> jax.Array:
    """Device-side inverse of pack2bit: [P, ceil(n/4)] -> [P, n] uint8."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    u = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    return u.reshape(packed.shape[0], -1)[:, :n]


def _window_mask(lo: jax.Array, hi: jax.Array, wlen: int) -> jax.Array:
    """rvalid from per-pair in-contig bounds: column j valid iff lo<=j<hi."""
    j = jnp.arange(wlen, dtype=jnp.int32)[None, :]
    return (j >= lo[:, None]) & (j < hi[:, None])


@functools.partial(jax.jit, static_argnames=("l", "wlen", "scoring"))
def extend_banded_scores_packed(
    q_pack: jax.Array,  # uint8 [P, ceil(l/4)] 2-bit packed query codes
    q_len: jax.Array,  # int32 [P]
    r_pack: jax.Array,  # uint8 [P, ceil(wlen/4)] 2-bit packed ref window
    lo: jax.Array,  # int32 [P] first valid window column
    hi: jax.Array,  # int32 [P] one past last valid window column
    l: int,
    wlen: int,
    scoring: SrScoring = SrScoring(),
) -> tuple[jax.Array, jax.Array]:
    """Transfer-compact variant of extend_banded_scores: codes arrive 2-bit
    packed and the validity mask arrives as [lo, hi) bounds; both are
    expanded on device (XLA fuses the unpack into the scan's slice reads)."""
    q = _unpack2bit(q_pack, l)
    r = _unpack2bit(r_pack, wlen)
    res = _extend_impl(q, q_len, r, _window_mask(lo, hi, wlen), scoring, False)
    return res.score, res.end_d


@functools.partial(jax.jit, static_argnames=("l", "wlen", "scoring"))
def extend_banded_packed(
    q_pack: jax.Array,
    q_len: jax.Array,
    r_pack: jax.Array,
    lo: jax.Array,
    hi: jax.Array,
    l: int,
    wlen: int,
    scoring: SrScoring = SrScoring(),
) -> ExtendResult:
    q = _unpack2bit(q_pack, l)
    r = _unpack2bit(r_pack, wlen)
    return _extend_impl(q, q_len, r, _window_mask(lo, hi, wlen), scoring, True)


@functools.partial(jax.jit, static_argnames=("scoring",))
def extend_banded(
    q_codes: jax.Array,  # int8/uint8 [P, L] strand-adjusted query codes
    q_len: jax.Array,  # int32 [P] actual query lengths (<= L)
    rwin: jax.Array,  # uint8 [P, L + BAND] ref window codes
    rwin_valid: jax.Array,  # bool [P, L + BAND] in-contig mask for the window
    scoring: SrScoring = SrScoring(),
) -> ExtendResult:
    return _extend_impl(q_codes, q_len, rwin, rwin_valid, scoring, True)


def _extend_impl(
    q_codes: jax.Array,
    q_len: jax.Array,
    rwin: jax.Array,
    rwin_valid: jax.Array,
    scoring: SrScoring,
    collect_plane: bool,
) -> ExtendResult:
    p, l = q_codes.shape
    o1 = jnp.float32(scoring.gap_open1 + scoring.gap_ext1)
    e1 = jnp.float32(scoring.gap_ext1)
    o2 = jnp.float32(scoring.gap_open2 + scoring.gap_ext2)
    e2 = jnp.float32(scoring.gap_ext2)
    band = rwin.shape[1] - l  # window width beyond the query length
    d_idx = jnp.arange(band, dtype=jnp.float32)

    def row(carry, xs):
        h_prev, i1_prev, i2_prev, best, best_d = carry
        qc, _, i = xs  # qc: [P] this row's query codes; i: row index

        # window columns for this row: offsets i .. i+BAND-1
        rrow = jax.lax.dynamic_slice(
            rwin, (jnp.int32(0), i), (p, band)
        )
        rval = jax.lax.dynamic_slice(
            rwin_valid, (jnp.int32(0), i), (p, band)
        )
        sub = jnp.where(
            rrow == qc[:, None],
            jnp.float32(scoring.match),
            jnp.float32(-scoring.mismatch),
        )
        sub = jnp.where(rval, sub, NEG)  # never align into the contig guard

        h_diag = h_prev + sub  # same-d: (i-1, j-1) -> (i, j)
        # insertions (query consumed, ref not): from previous row, d+1
        shift = lambda x: jnp.concatenate([x[:, 1:], jnp.full((p, 1), NEG)], axis=1)
        i1 = jnp.maximum(shift(h_prev) - o1, shift(i1_prev) - e1)
        i2 = jnp.maximum(shift(h_prev) - o2, shift(i2_prev) - e2)
        pmax = jnp.maximum(h_diag, jnp.maximum(i1, i2))

        # deletions within the row via exclusive prefix max
        def delrow(o, e):
            keyed = pmax + d_idx[None, :] * e
            cm = jax.lax.cummax(keyed, axis=1)
            cm_excl = jnp.concatenate(
                [jnp.full((p, 1), NEG), cm[:, :-1]], axis=1
            )
            return cm_excl - o - d_idx[None, :] * e

        # gap of length g costs O + g*E: the prefix-max uses the bare open
        d1 = delrow(jnp.float32(scoring.gap_open1), e1)
        d2 = delrow(jnp.float32(scoring.gap_open2), e2)
        h = jnp.maximum(pmax, jnp.maximum(d1, d2))

        is_last = i == (q_len - 1)  # [P]
        row_best_d = jnp.argmax(h, axis=1).astype(jnp.int32)
        row_best = jnp.take_along_axis(h, row_best_d[:, None], axis=1)[:, 0]
        best = jnp.where(is_last, row_best, best)
        best_d = jnp.where(is_last, row_best_d, best_d)
        return (h, i1, i2, best, best_d), (pmax if collect_plane else None)

    h0 = jnp.zeros((p, band), jnp.float32)  # free ref-overhang start
    i10 = jnp.full((p, band), NEG)
    i20 = jnp.full((p, band), NEG)
    best0 = jnp.full(p, NEG)
    bestd0 = jnp.zeros(p, jnp.int32)
    xs = (
        q_codes.T,  # [L, P]
        jnp.zeros(l, jnp.int32),
        jnp.arange(l, dtype=jnp.int32),
    )
    (_, _, _, best, best_d), p_planes = jax.lax.scan(
        row, (h0, i10, i20, best0, bestd0), xs
    )
    if not collect_plane:
        p_planes = jnp.zeros((p, 0, band), jnp.float32)
    else:
        p_planes = p_planes.transpose(1, 0, 2)
    return ExtendResult(score=best, end_d=best_d, p_plane=p_planes)


# --- host traceback ----------------------------------------------------------

CIG_EQ, CIG_X, CIG_I, CIG_D = "=", "X", "I", "D"


def _reconstruct(p_plane, o, e):
    """D plane of one gap family from the P plane row: vectorized over rows."""
    l, band = p_plane.shape
    d_idx = np.arange(band, dtype=np.float32)
    keyed = p_plane + d_idx[None, :] * e
    cm = np.maximum.accumulate(keyed, axis=1)
    cm_excl = np.concatenate([np.full((l, 1), NEG), cm[:, :-1]], axis=1)
    return cm_excl - o - d_idx[None, :] * e


def _reconstruct_batch(pp, o, e):
    """D planes of one gap family, vectorized over pairs AND rows:
    pp [G, L, BAND] -> [G, L, BAND]."""
    band = pp.shape[2]
    d_idx = np.arange(band, dtype=np.float32)
    keyed = pp + d_idx * e
    cm = np.maximum.accumulate(keyed, axis=2)
    out = np.empty_like(pp)
    out[:, :, 0] = NEG
    out[:, :, 1:] = cm[:, :, :-1]
    out -= o + d_idx * e
    return out


def reconstruct_planes(
    p_planes: np.ndarray,  # f32 [G, L, BAND]
    scoring: SrScoring = SrScoring(),
) -> tuple[np.ndarray, ...]:
    """Rebuild the H / D1 / D2 / I1 / I2 planes for a whole batch of gapped
    pairs at once (the round-1 per-pair python row loop was ~10 ms per pair;
    this is a handful of [G, L, BAND] numpy passes + an L-step loop over
    [G, BAND] rows shared by every pair). Rows beyond a pair's qlen are
    garbage — the per-pair walk never reads them."""
    o1, e1 = float(scoring.gap_open1 + scoring.gap_ext1), float(scoring.gap_ext1)
    o2, e2 = float(scoring.gap_open2 + scoring.gap_ext2), float(scoring.gap_ext2)
    g, l, band = p_planes.shape
    d1 = _reconstruct_batch(p_planes, float(scoring.gap_open1), e1)
    d2 = _reconstruct_batch(p_planes, float(scoring.gap_open2), e2)
    h = np.maximum(p_planes, np.maximum(d1, d2))
    i1 = np.full((g, l, band), NEG, np.float32)
    i2 = np.full((g, l, band), NEG, np.float32)
    i1[:, 0, : band - 1] = -o1
    i2[:, 0, : band - 1] = -o2
    for i in range(1, l):  # row recurrence, vectorized over all pairs
        hs = np.concatenate(
            [h[:, i - 1, 1:], np.full((g, 1), NEG, np.float32)], axis=1
        )
        i1s = np.concatenate(
            [i1[:, i - 1, 1:], np.full((g, 1), NEG, np.float32)], axis=1
        )
        i2s = np.concatenate(
            [i2[:, i - 1, 1:], np.full((g, 1), NEG, np.float32)], axis=1
        )
        i1[:, i] = np.maximum(hs - o1, i1s - e1)
        i2[:, i] = np.maximum(hs - o2, i2s - e2)
    return h, d1, d2, i1, i2


def traceback_walk(
    planes: tuple[np.ndarray, ...],  # (h, d1, d2, i1, i2) slices [L, BAND]
    pp: np.ndarray,  # f32 [L, BAND] the P plane of this pair
    q_codes: np.ndarray,  # [L]
    qlen: int,
    rwin: np.ndarray,  # [L + BAND]
    end_d: int,
    scoring: SrScoring = SrScoring(),
    rvalid: np.ndarray | None = None,  # [L + BAND] in-contig mask
) -> tuple[list[tuple[int, str]], int]:
    """Walk the optimal path over prebuilt planes (reconstruct_planes).

    On score ties the diagonal move wins (match preferred over gap, the
    minimap2 convention); this also yields the best locally-trimmable path
    when a free-overhang start makes several glocal optima tie.

    Returns (cigar run-length list [(n, op)], start_d) where start_d is the
    band offset at query row 0 (alignment ref start = window_start + start_d).
    """
    o1, e1 = float(scoring.gap_open1 + scoring.gap_ext1), float(scoring.gap_ext1)
    o2, e2 = float(scoring.gap_open2 + scoring.gap_ext2), float(scoring.gap_ext2)
    h, d1, d2, i1, i2 = planes
    band = pp.shape[1]
    eps = 1e-3
    ops: list[str] = []
    i, d = qlen - 1, int(end_d)
    state = "H"
    while i >= 0:
        if state == "H":
            val = h[i, d]
            if abs(val - pp[i, d]) > eps:
                # came from a deletion family
                state = "D1" if abs(val - d1[i, d]) <= eps else "D2"
                continue
            # P = max(diag, I): disambiguate, diagonal first (ties -> match)
            cell_ok = rvalid is None or rvalid[i + d]
            match = cell_ok and q_codes[i] == rwin[i + d]
            if cell_ok:
                sub = (
                    float(scoring.match) if match else -float(scoring.mismatch)
                )
                h_up = h[i - 1, d] if i > 0 else 0.0
                if abs(pp[i, d] - (h_up + sub)) <= eps:
                    ops.append(CIG_EQ if match else CIG_X)
                    i -= 1
                    state = "H"
                    continue
            if abs(pp[i, d] - i1[i, d]) <= eps:
                state = "I1"
                continue
            if abs(pp[i, d] - i2[i, d]) <= eps:
                state = "I2"
                continue
            # diagonal (reached only without an rvalid mask, by elimination)
            ops.append(CIG_EQ if match else CIG_X)
            i -= 1
            state = "H"
        elif state in ("D1", "D2"):
            o, e, dd = (
                (float(scoring.gap_open1), e1, d1)
                if state == "D1"
                else (float(scoring.gap_open2), e2, d2)
            )
            # find gap start d' < d: dd[i, d] = P[i, d'] - o - (d - d')*e
            target = dd[i, d]
            dprime = None
            for dp in range(d - 1, -1, -1):
                if abs((pp[i, dp] - o - (d - dp) * e) - target) <= eps:
                    dprime = dp
                    break
            assert dprime is not None, "deletion traceback failed"
            ops.extend(CIG_D * (d - dprime))
            d = dprime
            state = "H"
        else:  # I1 / I2
            e, o, ii = (e1, o1, i1) if state == "I1" else (e2, o2, i2)
            val = ii[i, d]
            if i == 0:
                hs = 0.0  # virtual row -1 (free ref-overhang start)
            else:
                hs = h[i - 1, d + 1] if d + 1 < band else NEG
            ops.append(CIG_I)
            if abs(val - (hs - o)) <= eps:
                state = "H"
            # else: gap extension, stay in the same I family
            i -= 1
            d += 1
    assert state == "H"
    start_d = d
    ops.reverse()
    # run-length encode
    rle: list[tuple[int, str]] = []
    for op in ops:
        if rle and rle[-1][1] == op:
            rle[-1] = (rle[-1][0] + 1, op)
        else:
            rle.append((1, op))
    return rle, start_d


def traceback_one(
    p_plane: np.ndarray,  # f32 [L, BAND] (rows beyond qlen ignored)
    q_codes: np.ndarray,
    qlen: int,
    rwin: np.ndarray,
    end_d: int,
    scoring: SrScoring = SrScoring(),
    rvalid: np.ndarray | None = None,
) -> tuple[list[tuple[int, str]], int]:
    """Single-pair convenience: reconstruct planes + walk. Batch callers use
    reconstruct_planes once over all gapped pairs, then traceback_walk each."""
    pp = p_plane[:qlen][None]
    planes = tuple(x[0] for x in reconstruct_planes(pp, scoring))
    return traceback_walk(
        planes, pp[0], q_codes, qlen, rwin, end_d, scoring, rvalid
    )


def align_oracle(q: np.ndarray, r: np.ndarray, scoring: SrScoring = SrScoring()):
    """O(L*R) full (unbanded) dual-affine glocal DP, scalar transliteration,
    for tests: best score of aligning ALL of q within r (free ref overhangs)."""
    lq, lr = len(q), len(r)
    o1, e1 = scoring.gap_open1 + scoring.gap_ext1, scoring.gap_ext1
    o2, e2 = scoring.gap_open2 + scoring.gap_ext2, scoring.gap_ext2
    neg = -1e30
    h_prev = np.zeros(lr + 1)  # row i=0: free leading ref overhang
    i1_prev = np.full(lr + 1, neg)
    i2_prev = np.full(lr + 1, neg)
    for i in range(1, lq + 1):
        h = np.full(lr + 1, neg)
        i1 = np.full(lr + 1, neg)
        i2 = np.full(lr + 1, neg)
        d1 = d2 = neg
        for j in range(lr + 1):
            i1[j] = max(h_prev[j] - o1, i1_prev[j] - e1)
            i2[j] = max(h_prev[j] - o2, i2_prev[j] - e2)
            best = max(i1[j], i2[j])
            if j > 0:
                s = scoring.match if q[i - 1] == r[j - 1] else -scoring.mismatch
                best = max(best, h_prev[j - 1] + s)
                d1 = max(h[j - 1] - o1, d1 - e1)
                d2 = max(h[j - 1] - o2, d2 - e2)
                best = max(best, d1, d2)
            h[j] = best
        h_prev, i1_prev, i2_prev = h, i1, i2
    return float(h_prev.max())
