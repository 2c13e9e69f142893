"""Device-resident align flush: chain -> select -> extend in one program.

An earlier align path ran three host round trips per flush (chain fetch,
host candidate selection, extension window upload) and built every ref
window on the host, which left the stage host-bound. This module keeps the
whole primary-alignment decision on device:

  host:   anchor collection, padded anchor upload, 2-bit ref pool upload
  device: chain DP per anchor bucket (ops.chain) -> per-pair candidate
          selection (primary + split-read segments + s2, minimap2's
          mask_level rules) -> ref window GATHER from the pooled genome
          buffer -> banded extension score pass (ops.extend._extend_impl)
          -> gapless + full-span checks -> one packed result fetch
  host:   CIGAR/record assembly from the fetched mismatch bitmask; the
          rare gapped / supplementary / trimmed cases delegate to the
          engine's traceback path (byte-identical records)

Replaces the same reference behavior as align.engine.flush_pairs (one
minimap2 process per candidate genome,
/root/reference/scripts/batch_align.py:416-486); selection semantics are
bit-identical to the host path (tested A/B in tests/test_fused_align.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from phylign_tpu.ops import chain as opc
from phylign_tpu.ops import extend as ope
from phylign_tpu.ops.extend import SrScoring, _extend_impl, _window_mask
NEG = np.float32(-1e30)

# flag bits in the packed int output (column FLAGS of the ints array)
F_HAS = 1  # a primary candidate passed the chain thresholds
F_DIAG = 2  # extension optimum is realized gaplessly on the end diagonal
F_FULL = 4  # gapless AND untrimmable (full-span Kadane optimum) AND >= -s
F_STRAND = 8  # primary candidate strand (1 = reverse)
F_PRIMTYPE = 16  # primary candidate is a strand-set primary (alt is valid)
F_SUP0 = 32  # supplementary segment s found -> bit (5 + s)
F_PROBE = 128  # s2 > 0: the competitor's coords ride in the cold payload
# for the MAPQ dp_max2 probe extension (mm2 hit.c mm_set_mapq). The flag
# byte caps n_sup at 2 (bits 5-6): flush_pairs_begin routes larger
# max_segments to the host path.

COLD_CAP = 512  # compacted delegation rows shipped with the hot fetch


def pack2bit_flat(a: np.ndarray) -> np.ndarray:
    """[N] uint8 codes (0..3) -> [ceil(N/4)] uint8 (code j in bits 2*(j%4))."""
    npad = (-len(a)) % 4
    if npad:
        a = np.concatenate([a, np.zeros(npad, np.uint8)])
    a4 = a.reshape(-1, 4)
    return a4[:, 0] | (a4[:, 1] << 2) | (a4[:, 2] << 4) | (a4[:, 3] << 6)


def _gather_codes(pool_pack: jax.Array, idx: jax.Array) -> jax.Array:
    """2-bit code at flat position idx (any shape) from the packed pool."""
    idxc = jnp.clip(idx, 0, pool_pack.shape[0] * 4 - 1)
    byte = pool_pack[idxc >> 2]
    return (byte >> ((idxc & 3).astype(jnp.uint8) * 2)) & jnp.uint8(3)


def _flatten_chains(chains) -> dict[str, jax.Array]:
    """Concat per-bucket ChainResults along the set axis + one dummy row
    (index S_tot) whose scores are -inf: candidate gathers for pairs missing
    a strand point there."""

    def cat(field, dummy):
        parts = [getattr(c, field) for c in chains]
        d = jnp.full((1,) + parts[0].shape[1:], dummy, parts[0].dtype)
        return jnp.concatenate(parts + [d], axis=0)

    return dict(
        score=cat("score", NEG),
        count=cat("count", 0),
        qs=cat("qs", 0),
        qe=cat("qe", 0),
        rs=cat("rs", 0),
        re=cat("re", 0),
        alt=cat("alt_score", NEG),
        alt_qs=cat("alt_qs", 0),
        alt_qe=cat("alt_qe", 0),
        alt_rs=cat("alt_rs", 0),
        alt_re=cat("alt_re", 0),
        sup_score=cat("sup_score", NEG),
        sup_count=cat("sup_count", 0),
        sup_qs=cat("sup_qs", 0),
        sup_qe=cat("sup_qe", 0),
        sup_rs=cat("sup_rs", 0),
        sup_re=cat("sup_re", 0),
    )


def _select_extend_core(
    flat: dict[str, jax.Array],
    cand_map: jax.Array,  # int32 [P, 2] flat set idx (plus, minus); S_tot=none
    pair_base: jax.Array,  # int32 [P] pool base offset of the pair's ref
    pair_reflen: jax.Array,  # int32 [P] len(ref.codes)
    q_pack: jax.Array,  # uint8 [P, ceil(lmax/4)] FORWARD packed queries
    q_len: jax.Array,  # int32 [P]
    pool_pack: jax.Array,  # uint8 [ceil(pool_len/4)] 2-bit pool codes
    cst: jax.Array,  # int32 [C] pool-coord contig starts (sorted, pad=MAX)
    clen: jax.Array,  # int32 [C] contig lengths (pad=0)
    *,
    lmax: int,
    wlen: int,
    half: int,
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int,
):
    p = cand_map.shape[0]
    n_sup = flat["sup_score"].shape[1]
    c_total = 2 * (1 + n_sup)

    # --- candidate tensors [P, C]; order = host insertion order -------------
    # (engine.flush_pairs builds each pair's list as [P+, P-, S+0..,S-0..];
    # its stable sort therefore breaks full-key ties by this order)
    si = cand_map  # [P, 2]

    def gcat(prim_field, sup_field):
        pv = flat[prim_field][si]  # [P, 2]
        sv = flat[sup_field][si]  # [P, 2, n_sup]
        return jnp.concatenate([pv, sv[:, 0], sv[:, 1]], axis=1)  # [P, C]

    c_score = gcat("score", "sup_score")
    c_count = gcat("count", "sup_count")
    c_qs = gcat("qs", "sup_qs")
    c_qe = gcat("qe", "sup_qe")
    c_rs = gcat("rs", "sup_rs")
    c_re = gcat("re", "sup_re")
    # alt (s2 competitor) only exists for strand-set primaries; host clips >=0
    alt2 = jnp.maximum(flat["alt"][si], 0.0)  # [P, 2]
    c_alt = jnp.concatenate(
        [alt2, jnp.zeros((p, 2 * n_sup), jnp.float32)], axis=1
    )
    strand_row = np.array([0, 1] + [0] * n_sup + [1] * n_sup, np.int32)
    c_strand = jnp.broadcast_to(jnp.asarray(strand_row)[None, :], (p, c_total))
    c_valid = (c_count >= min_cnt) & (c_score >= jnp.float32(min_score))

    def lex_select(valid):
        """argmin over candidates of (-score, strand, qs, insertion order):
        iterate ascending c with strict comparisons — first wins ties."""
        has = jnp.zeros(p, bool)
        b_sc = jnp.full(p, NEG)
        b_st = jnp.zeros(p, jnp.int32)
        b_qs = jnp.zeros(p, jnp.int32)
        b_c = jnp.zeros(p, jnp.int32)
        for c in range(c_total):
            sc, st, qs = c_score[:, c], c_strand[:, c], c_qs[:, c]
            better = valid[:, c] & (
                ~has
                | (sc > b_sc)
                | ((sc == b_sc) & (st < b_st))
                | ((sc == b_sc) & (st == b_st) & (qs < b_qs))
            )
            b_sc = jnp.where(better, sc, b_sc)
            b_st = jnp.where(better, st, b_st)
            b_qs = jnp.where(better, qs, b_qs)
            b_c = jnp.where(better, c, b_c)
            has = has | better
        return has, b_c

    has_prim, prim_c = lex_select(c_valid)
    take_c = lambda arr, c: jnp.take_along_axis(arr, c[:, None], axis=1)[:, 0]
    prim_score = take_c(c_score, prim_c)
    prim_count = take_c(c_count, prim_c)  # chain anchor count (cm:i)
    prim_strand = take_c(c_strand, prim_c)
    prim_qs = take_c(c_qs, prim_c)
    prim_qe = take_c(c_qe, prim_c)
    prim_rs = take_c(c_rs, prim_c)
    prim_re = take_c(c_re, prim_c)
    prim_alt = take_c(c_alt, prim_c)
    prim_is_primary = prim_c < 2  # strand-set primary (device alt applies)

    def qov_ge_half(aqs, aqe, bqs, bqe):
        """host _qov(a, b) >= 0.5 in exact integer arithmetic."""
        ov = jnp.maximum(0, jnp.minimum(aqe, bqe) - jnp.maximum(aqs, bqs))
        span = jnp.maximum(1, jnp.minimum(aqe - aqs, bqe - bqs))
        return 2 * ov >= span

    # s2: best OTHER candidate covering the primary's interval, or the
    # device alt of a strand-set primary (host: max(overlapping rest + alt))
    iota_c = jnp.arange(c_total, dtype=jnp.int32)[None, :]
    others = c_valid & (iota_c != prim_c[:, None])
    ov_ok = qov_ge_half(c_qs, c_qe, prim_qs[:, None], prim_qe[:, None])
    over_sc = jnp.where(others & ov_ok, c_score, NEG)
    c2 = jnp.argmax(over_sc, axis=1).astype(jnp.int32)
    s2_cand = take_c(over_sc, c2)
    alt_term = jnp.where(prim_is_primary & has_prim, prim_alt, 0.0)
    s2 = jnp.maximum(jnp.maximum(s2_cand, alt_term), 0.0)
    s2 = jnp.where(has_prim, s2, 0.0)

    # MAPQ dp_max2 probe target: the s2 competitor's region coordinates —
    # the best overlapping candidate (which has full coords), or the chain
    # DP's same-strand alt competitor of the primary's own set (whose
    # coords now ride in the ChainResult); candidate wins ties, matching
    # the host selection rule in engine.flush_pairs_host_grouped.
    use_alt = alt_term > jnp.maximum(s2_cand, 0.0)
    sidx = jnp.clip(prim_c, 0, 1)
    take_s = lambda arr: jnp.take_along_axis(arr[si], sidx[:, None], axis=1)[:, 0]
    probe_strand = jnp.where(use_alt, prim_strand, take_c(c_strand, c2))
    probe_qs = jnp.where(use_alt, take_s(flat["alt_qs"]), take_c(c_qs, c2))
    probe_qe = jnp.where(use_alt, take_s(flat["alt_qe"]), take_c(c_qe, c2))
    probe_rs = jnp.where(use_alt, take_s(flat["alt_rs"]), take_c(c_rs, c2))
    probe_re = jnp.where(use_alt, take_s(flat["alt_re"]), take_c(c_re, c2))
    has_probe = s2 > 0.0

    # supplementary segments: greedy best candidate mostly-disjoint from
    # every previously picked segment (mask_level 0.5; host loop order)
    taken = iota_c == prim_c[:, None]
    picked = [(prim_qs, prim_qe, has_prim)]
    sup_out = []
    for _s in range(max_segments - 1):
        blocked = jnp.zeros((p, c_total), bool)
        for pqs, pqe, plive in picked:
            ov = qov_ge_half(c_qs, c_qe, pqs[:, None], pqe[:, None])
            blocked = blocked | (ov & plive[:, None])
        okc = c_valid & ~taken & ~blocked & has_prim[:, None]
        found, ch = lex_select(okc)
        sup_out.append(
            dict(
                found=found,
                score=take_c(c_score, ch),
                strand=take_c(c_strand, ch),
                qs=take_c(c_qs, ch),
                qe=take_c(c_qe, ch),
                rs=take_c(c_rs, ch),
                re=take_c(c_re, ch),
                count=take_c(c_count, ch),
            )
        )
        taken = taken | ((iota_c == ch[:, None]) & found[:, None])
        picked.append((take_c(c_qs, ch), take_c(c_qe, ch), found))

    # --- primary extension: window gather + banded score pass ---------------
    rs_c = jnp.clip(prim_rs, 0, pair_reflen - 1) + pair_base
    ci = (
        jnp.searchsorted(cst, rs_c, side="right").astype(jnp.int32) - 1
    )
    c_start = cst[ci]
    c_end = c_start + clen[ci]
    w0 = pair_base + prim_rs - prim_qs - half
    lo = jnp.clip(c_start - w0, 0, wlen)
    hi = jnp.clip(c_end - w0, 0, wlen)
    win_idx = w0[:, None] + jnp.arange(wlen, dtype=jnp.int32)[None, :]
    rwin = _gather_codes(pool_pack, win_idx)  # [P, wlen] uint8
    # reverse complement computed ON DEVICE from the forward codes
    # (halves the query H2D; rcv's zero padding makes the bytes identical
    # to the former host-built rc upload)
    fwd_q = ope._unpack2bit(q_pack, lmax)
    col_q = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    ridx = jnp.clip(q_len[:, None] - 1 - col_q, 0, lmax - 1)
    rcv = jnp.where(
        col_q < q_len[:, None],
        (3 - jnp.take_along_axis(fwd_q, ridx, axis=1)).astype(jnp.uint8),
        jnp.uint8(0),
    )
    q_codes = jnp.where((prim_strand == 1)[:, None], rcv, fwd_q)
    ext_res = _extend_impl(
        q_codes, q_len, rwin, _window_mask(lo, hi, wlen), scoring, False
    )
    ext_score, end_d = ext_res.score, ext_res.end_d

    # --- gapless + full-span checks (device twins of engine._extend_finish) -
    cols = end_d[:, None] + jnp.arange(lmax, dtype=jnp.int32)[None, :]
    rseg = jnp.take_along_axis(rwin, cols, axis=1)
    in_q = jnp.arange(lmax, dtype=jnp.int32)[None, :] < q_len[:, None]
    vseg = (cols >= lo[:, None]) & (cols < hi[:, None]) | ~in_q
    neq_mask = (q_codes != rseg) & in_q
    neq = neq_mask.sum(axis=1, dtype=jnp.int32)
    m_s, x_s = scoring.match, scoring.mismatch
    best_gapless = m_s * (q_len - neq) - x_s * neq
    ext_i = jnp.clip(ext_score, -1e9, 1e9).astype(jnp.int32)
    diag_ok = vseg.all(axis=1) & (best_gapless == ext_i)
    full = diag_ok & (best_gapless >= scoring.min_dp_score)
    # the full interval is the unique Kadane optimum iff every proper
    # prefix/suffix scores strictly positive; minima occur at mismatches
    step = m_s + x_s
    cum = jnp.cumsum(neq_mask.astype(jnp.int32), axis=1)
    col_i = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    prefv = m_s * (col_i + 1) - step * cum
    sufv = m_s * (q_len[:, None] - col_i) - step * (neq[:, None] - cum + 1)
    big = jnp.int32(2**30)
    min_pref = jnp.min(jnp.where(neq_mask, prefv, big), axis=1)
    min_suf = jnp.min(jnp.where(neq_mask, sufv, big), axis=1)
    full = full & ((neq == 0) | ((min_pref > 0) & (min_suf > 0)))
    # internal z-drop twin (engine._extend_finish): a > zdrop fall from a
    # running peak fails the fast path — the host then splits the region
    # the way mm2's z-dropped gap fill does. Peaks sit just before
    # mismatch columns, valleys just after.
    r_before = m_s * col_i - step * (cum - 1)
    runpeak = jax.lax.cummax(jnp.where(neq_mask, r_before, -big), axis=1)
    dropmax = jnp.max(jnp.where(neq_mask, runpeak - prefv, -big), axis=1)
    full = full & (dropmax <= jnp.int32(zdrop))

    # --- pack outputs: a small HOT payload fetched every flush + a COLD
    # payload (delegation coordinates: gapped primaries, supplementary
    # segments) fetched only when the flags show such rows exist, so the
    # common flush fetches few bytes.
    flags = (
        has_prim.astype(jnp.int32) * F_HAS
        | diag_ok.astype(jnp.int32) * F_DIAG
        | full.astype(jnp.int32) * F_FULL
        | prim_strand.astype(jnp.int32) * F_STRAND
        | prim_is_primary.astype(jnp.int32) * F_PRIMTYPE
    )
    for s, so in enumerate(sup_out):
        flags = flags | so["found"].astype(jnp.int32) * (F_SUP0 << s)
    flags = flags | has_probe.astype(jnp.int32) * F_PROBE
    hot = jnp.stack(
        [(w0 - c_start), ci, flags | (end_d << 8), prim_count], axis=1
    ).astype(jnp.int32)
    flts = jnp.stack([prim_score, s2], axis=1)
    # mismatch bitmask packed big-endian to match np.unpackbits on the host
    bits = neq_mask.reshape(p, lmax // 8, 8).astype(jnp.uint8)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    neq_pack = (bits * weights[None, None, :]).sum(axis=2).astype(jnp.uint8)
    cold_ints = [prim_qs, prim_qe, prim_rs, prim_re]
    for so in sup_out:
        cold_ints += [
            so["strand"], so["qs"], so["qe"], so["rs"], so["re"], so["count"]
        ]
    # probe coords last (base column 4 + 6*n_sup, read by _fused_finish)
    cold_ints += [probe_strand, probe_qs, probe_qe, probe_rs, probe_re]
    cold_i = jnp.stack(cold_ints, axis=1).astype(jnp.int32)
    cold_f = (
        jnp.stack([so["score"] for so in sup_out], axis=1)
        if sup_out
        else jnp.zeros((p, 0), jnp.float32)
    )
    return hot, flts, neq_pack, (cold_i, cold_f)


def _compact_cold(hot, cold_i, cold_f):
    """Compact the needed cold rows (gapped primary OR any supplementary,
    read from the hot flag word) into COLD_CAP slots shipped WITH the hot
    fetch: the rare delegation rows then cost zero extra round trips.
    Overflow (> COLD_CAP needed rows) is detected on host from the flags and
    falls back to fetching the full cold arrays. Single-device only — a
    per-shard cumsum would misnumber ranks on a mesh."""
    flags = hot[:, 2]
    sup_bits = ~jnp.int32(F_SUP0 - 1)  # any bit >= F_SUP0
    gapped = ((flags & F_HAS) != 0) & ((flags & F_FULL) == 0)
    need = gapped | ((flags & (0xFF & sup_bits)) != 0)
    rank = jnp.cumsum(need.astype(jnp.int32)) - 1
    pos = jnp.where(need & (rank < COLD_CAP), rank, COLD_CAP)
    ci = jnp.zeros((COLD_CAP, cold_i.shape[1]), jnp.int32).at[pos].set(
        cold_i, mode="drop"
    )
    cf = jnp.zeros((COLD_CAP, cold_f.shape[1]), jnp.float32).at[pos].set(
        cold_f, mode="drop"
    )
    return ci, cf


def _bitcast_u8(a):
    """Flatten any int32/float32/uint8 array to its little-endian bytes."""
    if a.dtype == jnp.uint8:
        return a.reshape(-1)
    return jax.lax.bitcast_convert_type(a, jnp.uint8).reshape(-1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "lmax", "wlen", "half", "scoring", "min_cnt", "min_score",
        "max_segments", "zdrop", "pack",
    ),
)
def select_extend(
    chains,
    cand_map,
    pair_base,
    pair_reflen,
    q_pack,
    q_len,
    pool_pack,
    cst,
    clen,
    *,
    lmax: int,
    wlen: int,
    half: int,
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int = 100,
    pack: bool = False,
):
    """Single-device fused selection + extension over per-bucket chain
    results (device arrays from ops.chain — never fetched). Returns
    (hot, flts, neq_pack, cold_compact, cold_full); callers fetch the first
    four together and cold_full only on compaction overflow.

    ``pack=True`` instead returns (packed_u8, cold_full) with hot / flts /
    neq / compacted-cold bitcast into ONE 1-D byte buffer, so the
    production flush fetches a single array per chunk
    (engine._fused_finish unpacks by fixed offsets)."""
    hot, flts, neq_pack, cold = _select_extend_core(
        _flatten_chains(chains),
        cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack,
        cst, clen,
        lmax=lmax, wlen=wlen, half=half, scoring=scoring,
        min_cnt=min_cnt, min_score=min_score, max_segments=max_segments,
        zdrop=zdrop,
    )
    cc_i, cc_f = _compact_cold(hot, *cold)
    if not pack:
        return hot, flts, neq_pack, (cc_i, cc_f), cold
    packed = jnp.concatenate(
        [_bitcast_u8(a) for a in (hot, flts, neq_pack, cc_i, cc_f)]
    )
    return packed, cold


def dist_select_extend(
    mesh,
    chains,
    cand_map,
    pair_base,
    pair_reflen,
    q_pack,
    q_len,
    pool_pack,
    cst,
    clen,
    *,
    lmax: int,
    wlen: int,
    half: int,
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int = 100,
):
    """Mesh twin: pair-axis arrays are dp-sharded over 'q'; the (small)
    per-set chain outputs are all-gathered so every shard can gather any
    pair's candidates; the genome pool and contig table are replicated."""
    from jax.sharding import PartitionSpec as P

    from phylign_tpu.parallel.dist import shard_map
    from phylign_tpu.parallel.mesh import AXIS_QUERY

    chain_spec = type(chains[0])(
        score=P(AXIS_QUERY), count=P(AXIS_QUERY), qs=P(AXIS_QUERY),
        qe=P(AXIS_QUERY), rs=P(AXIS_QUERY), re=P(AXIS_QUERY),
        alt_score=P(AXIS_QUERY),
        alt_qs=P(AXIS_QUERY), alt_qe=P(AXIS_QUERY),
        alt_rs=P(AXIS_QUERY), alt_re=P(AXIS_QUERY),
        sup_score=P(AXIS_QUERY, None), sup_count=P(AXIS_QUERY, None),
        sup_qs=P(AXIS_QUERY, None), sup_qe=P(AXIS_QUERY, None),
        sup_rs=P(AXIS_QUERY, None), sup_re=P(AXIS_QUERY, None),
    )

    def step(chains_loc, cm, pb, prl, qp, ql, pool, cst_, clen_):
        full = jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, AXIS_QUERY, axis=0, tiled=True),
            chains_loc,
        )
        return _select_extend_core(
            _flatten_chains(full), cm, pb, prl, qp, ql, pool, cst_, clen_,
            lmax=lmax, wlen=wlen, half=half, scoring=scoring,
            min_cnt=min_cnt, min_score=min_score, max_segments=max_segments,
            zdrop=zdrop,
        )

    return shard_map(
        step,
        mesh,
        in_specs=(
            tuple(chain_spec for _ in chains),
            P(AXIS_QUERY, None),  # cand_map
            P(AXIS_QUERY),  # pair_base
            P(AXIS_QUERY),  # pair_reflen
            P(AXIS_QUERY, None),  # q_pack
            P(AXIS_QUERY),  # q_len
            P(None),  # pool_pack (replicated)
            P(None),  # cst
            P(None),  # clen
        ),
        out_specs=(
            P(AXIS_QUERY, None),
            P(AXIS_QUERY, None),
            P(AXIS_QUERY, None),
            (P(AXIS_QUERY, None), P(AXIS_QUERY, None)),
        ),
    )(tuple(chains), cand_map, pair_base, pair_reflen, q_pack, q_len,
      pool_pack, cst, clen)
