"""Sharded match / top-k / align: the distributed compute path.

Design (SURVEY.md sections 2c.7, 5 "distributed communication backend"):
  * The Bloom bit-matrix's word columns are sharded over the "d" mesh axis.
    Scoring needs NO communication: every shard gathers k-mer rows of its own
    column slice and scores its own documents.
  * The filter's global top-k is the one real collective: local top-K per
    shard, all-gather of (value, global-doc-id) over "d", re-top-K. K =
    nb_best_hits + TIE_SLACK extra slots so ties at the cutoff survive the
    fixed shape; the host finalizes exact tie semantics from the returned
    scores (overflow beyond the slack is detectable: last kept value ==
    cutoff value).
  * Chaining/extension are embarrassingly data-parallel over "q".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P



def shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: kernel bodies create fresh carries (zeros) that the
    # varying-manual-axes checker would otherwise flag against sharded inputs
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )

from phylign_tpu.ops.chain import chain_anchors
from phylign_tpu.ops.extend import (
    SrScoring,
    extend_banded,
    extend_banded_packed,
    extend_banded_scores,
    extend_banded_scores_packed,
)
from phylign_tpu.ops.match import match_scores_xla
from phylign_tpu.parallel.mesh import AXIS_DOC, AXIS_QUERY

TIE_SLACK = 28


def global_array(mesh, arr, spec: P):
    """A mesh-global device array from a host array every process holds.

    Single-process this is device_put with a NamedSharding; multi-process
    (jax.distributed) each process contributes exactly the shards
    its local devices own — the only portable way to build an array on a
    mesh that spans processes."""
    import numpy as np
    from jax.sharding import NamedSharding

    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    if len(mesh.devices.flat) == len(jax.local_devices()):
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def fetch(tree):
    """device_get that also works on non-fully-addressable (multi-process)
    arrays: each process receives the full value."""
    leaves = jax.tree_util.tree_leaves(tree)
    if all(getattr(x, "is_fully_addressable", True) for x in leaves):
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    return jax.tree_util.tree_map(
        lambda x: multihost_utils.process_allgather(x, tiled=True)
        if not getattr(x, "is_fully_addressable", True)
        else jax.device_get(x),
        tree,
    )


def dist_match_scores(mesh, words, row_idx):
    """Sharded scoring: words [S+1, Wp] sharded over 'd' columns, row_idx
    [Q, K, H] sharded over 'q'. Returns scores [Q, 32*Wp] sharded (q, d).
    Zero communication."""

    def step(words_loc, rows_loc):
        return match_scores_xla(words_loc, rows_loc)

    return shard_map(
        step,
        mesh,
        in_specs=(P(None, AXIS_DOC), P(AXIS_QUERY, None, None)),
        out_specs=P(AXIS_QUERY, AXIS_DOC),
    )(words, row_idx)


def dist_topk(mesh, scores, n_best, k_total=None):
    """Global per-query top-K across doc shards.

    scores: [Q, D] sharded (q, d). Returns (values [Q, K], global doc ids
    [Q, K]) replicated over 'd', sharded over 'q'. K = n_best + TIE_SLACK,
    or exactly ``k_total`` when given.
    """
    k = k_total if k_total is not None else n_best + TIE_SLACK

    def step(s_loc):
        kl = min(k, s_loc.shape[1])
        v, i = jax.lax.top_k(s_loc, kl)
        d_idx = jax.lax.axis_index(AXIS_DOC)
        gi = i + d_idx * s_loc.shape[1]
        vg = jax.lax.all_gather(v, AXIS_DOC, axis=1, tiled=True)
        ig = jax.lax.all_gather(gi, AXIS_DOC, axis=1, tiled=True)
        kk = min(k, vg.shape[1])
        v2, sel = jax.lax.top_k(vg, kk)
        i2 = jnp.take_along_axis(ig, sel, axis=1)
        return v2, i2

    return shard_map(
        step,
        mesh,
        in_specs=(P(AXIS_QUERY, AXIS_DOC),),
        out_specs=(P(AXIS_QUERY, None), P(AXIS_QUERY, None)),
    )(scores)


@functools.partial(jax.jit, static_argnames=("mesh", "d", "kk"))
def dist_threshold_topk(mesh, words, row_idx, cut, d: int, kk: int):
    """Fused sharded match->threshold->top-k as ONE jitted global program:
    scoring is zero-communication over doc shards, the top-k is the one
    all-gather collective, and the qualifying count reduces over 'd'.
    Returns (vals [Q, kk], global doc ids [Q, kk], n_keep [Q]), all
    replicated over 'd'. Works on single-process and multi-process
    (jax.distributed) meshes — multi-process requires the whole computation
    inside one jit, which also saves dispatch round trips single-chip."""
    scores = dist_match_scores(mesh, words, row_idx)

    def mask_step(s_loc, cut_loc):
        d_idx = jax.lax.axis_index(AXIS_DOC)
        w_loc = s_loc.shape[1]
        col0 = d_idx * w_loc
        loc_cols = col0 + jnp.arange(w_loc, dtype=jnp.int32)
        ok = (s_loc >= cut_loc[:, None]) & (loc_cols[None, :] < d)
        masked = jnp.where(ok, s_loc, -1)
        n_loc = ok.sum(axis=1, dtype=jnp.int32)
        n_keep = jax.lax.psum(n_loc, AXIS_DOC)
        return masked, n_keep

    masked, n_keep = shard_map(
        mask_step,
        mesh,
        in_specs=(P(AXIS_QUERY, AXIS_DOC), P(AXIS_QUERY)),
        out_specs=(P(AXIS_QUERY, AXIS_DOC), P(AXIS_QUERY)),
    )(scores, cut)
    vals, ids = dist_topk(mesh, masked, 0, k_total=kk)
    return vals, ids, n_keep


def dist_chain(mesh, rpos, qpos, **kw):
    """Chain DP data-parallel over 'q' (pairs axis)."""

    def step(r, q):
        return chain_anchors(r, q, **kw)

    return shard_map(
        step,
        mesh,
        in_specs=(P(AXIS_QUERY, None), P(AXIS_QUERY, None)),
        out_specs=P(AXIS_QUERY),
    )(rpos, qpos)


def dist_extend(mesh, q_codes, q_len, rwin, rvalid, scoring=SrScoring()):
    """Banded extension data-parallel over 'q' (pairs axis)."""

    def step(qc, ql, rw, rv):
        return extend_banded(qc, ql, rw, rv, scoring=scoring)

    return shard_map(
        step,
        mesh,
        in_specs=(
            P(AXIS_QUERY, None),
            P(AXIS_QUERY),
            P(AXIS_QUERY, None),
            P(AXIS_QUERY, None),
        ),
        out_specs=P(AXIS_QUERY),
    )(q_codes, q_len, rwin, rvalid)


def dist_extend_scores(mesh, q_codes, q_len, rwin, rvalid, scoring=SrScoring()):
    """Score-only banded extension data-parallel over 'q' (no traceback
    plane): the align engine's common path for gapless short-read pairs."""

    def step(qc, ql, rw, rv):
        return extend_banded_scores(qc, ql, rw, rv, scoring=scoring)

    return shard_map(
        step,
        mesh,
        in_specs=(
            P(AXIS_QUERY, None),
            P(AXIS_QUERY),
            P(AXIS_QUERY, None),
            P(AXIS_QUERY, None),
        ),
        out_specs=(P(AXIS_QUERY), P(AXIS_QUERY)),
    )(q_codes, q_len, rwin, rvalid)


_EXT_PACKED_SPECS = (
    P(AXIS_QUERY, None),  # q_pack
    P(AXIS_QUERY),  # q_len
    P(AXIS_QUERY, None),  # r_pack
    P(AXIS_QUERY),  # lo
    P(AXIS_QUERY),  # hi
)


def dist_extend_scores_packed(
    mesh, q_pack, q_len, r_pack, lo, hi, l: int, wlen: int, scoring=SrScoring()
):
    """Transfer-compact mesh twin of extend_banded_scores_packed: 2-bit
    packed codes + [lo, hi) window bounds, dp-sharded over 'q'. Same 4-5x
    H2D byte cut as the single-chip packed path (the mesh path previously
    uploaded raw uint8 windows + bool masks — 5x the bytes)."""

    def step(qp, ql, rp, lo_, hi_):
        return extend_banded_scores_packed(
            qp, ql, rp, lo_, hi_, l, wlen, scoring=scoring
        )

    return shard_map(
        step,
        mesh,
        in_specs=_EXT_PACKED_SPECS,
        out_specs=(P(AXIS_QUERY), P(AXIS_QUERY)),
    )(q_pack, q_len, r_pack, lo, hi)


def dist_extend_packed(
    mesh, q_pack, q_len, r_pack, lo, hi, l: int, wlen: int, scoring=SrScoring()
):
    """Traceback-plane mesh twin of extend_banded_packed (dp over 'q')."""

    def step(qp, ql, rp, lo_, hi_):
        return extend_banded_packed(
            qp, ql, rp, lo_, hi_, l, wlen, scoring=scoring
        )

    return shard_map(
        step,
        mesh,
        in_specs=_EXT_PACKED_SPECS,
        out_specs=P(AXIS_QUERY),
    )(q_pack, q_len, r_pack, lo, hi)


@functools.partial(jax.jit, static_argnames=("mesh", "threshold", "n_best"))
def full_step(
    mesh,
    words,
    row_idx,
    n_kmers,
    q_codes,
    q_len,
    rwin,
    rvalid,
    anchors_r,
    anchors_q,
    threshold: float = 0.7,
    n_best: int = 100,
):
    """The framework's full sharded compute step, jitted as one program:
    match (tp over doc columns) -> threshold mask -> distributed top-k
    (collective over 'd') -> chain + banded extension (dp over 'q').

    This is what dryrun_multichip compiles and executes on an N-device mesh.
    """
    scores = dist_match_scores(mesh, words, row_idx)
    d = scores.shape[1]
    cut = jnp.ceil(
        threshold * jnp.maximum(n_kmers, 1).astype(jnp.float32)
    ).astype(jnp.int32)
    kk = min(n_best + TIE_SLACK, d)
    topv, topi, n_keep = dist_threshold_topk(mesh, words, row_idx, cut, d, kk)
    chain_res = dist_chain(mesh, anchors_r, anchors_q)
    ext = dist_extend(mesh, q_codes, q_len, rwin, rvalid)
    return {
        "scores": scores,
        "top_values": topv,
        "top_doc_ids": topi,
        "top_n_keep": n_keep,
        "chain_score": chain_res.score,
        "chain_count": chain_res.count,
        "align_score": ext.score,
    }
